"""The block-store wrappers of tests/test_cachestore.py,
tests/test_prefetch.py and tests/test_blockstorestorage.py held between
the JAX package and the port, plus the LRU wrapper: each scenario runs
in both packages from one seed and returns what it observed (blocks
covered and fetched, bytes read back, errors, which gets reached the
backing store), which must be equal."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.torch_sides import (
    block_hashes,
    downsync,
    make_source,
    read_tree,
    same,
    upsync,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# CacheBlockStore (test_cachestore.py)
# ---------------------------------------------------------------------------

class OfflineStore:
    """A remote that fails every call (network down)."""

    def get_stored_block(self, h):
        raise ConnectionError("remote offline")

    def put_stored_block(self, b):
        raise ConnectionError("remote offline")

    def preflight_get(self, hashes):
        raise ConnectionError("remote offline")

    def get_existing_content(self, chunk_hashes,
                             min_block_usage_percent=0):
        raise ConnectionError("remote offline")

    def flush(self):
        pass


def populated_local(side):
    """Upsync a tree into a store that acts as the local cache tier."""
    storage = side.storage.MemStorage()
    storage.create_dir("src")
    files = make_source(storage, "src", np.random.default_rng(3))
    local = side.fsblockstore.FSBlockStore(storage, "cache")
    vi, _ = upsync(side, storage, "src", local, target_chunk_size=2048,
                   workers=2)
    return storage, files, local, vi


def covered(vi, idx) -> bool:
    return bool(np.isin(vi.chunk_hashes,
                        np.asarray(idx.chunk_hashes, np.uint64)).all())


def test_local_only_blocks_visible_to_planning():
    """Blocks only in the local tier count in get_existing_content, and a
    downsync completes from the local tier alone."""
    def scenario(side):
        storage, files, local, vi = populated_local(side)
        cache = side.cacheblockstore.CacheBlockStore(
            local, side.fsblockstore.FSBlockStore(storage, "remote"))
        idx = cache.get_existing_content(vi.chunk_hashes)
        downsync(side, cache, storage, "dst", vi, workers=2)
        assert read_tree(side, storage, "dst") == files
        cache.flush()
        return covered(vi, idx), block_hashes(idx), vi.to_bytes()

    assert same(scenario)[0]


def test_offline_remote_degrades_to_local():
    def scenario(side):
        storage, files, local, vi = populated_local(side)
        cache = side.cacheblockstore.CacheBlockStore(local, OfflineStore())
        idx = cache.get_existing_content(vi.chunk_hashes)
        downsync(side, cache, storage, "dst2", vi, workers=2)
        assert read_tree(side, storage, "dst2") == files
        cache.flush()
        return idx.block_count, block_hashes(idx)

    assert same(scenario)[0] > 0


def test_remote_precedence_and_writeback():
    """Blocks in both tiers plan from the remote's index; a remote get
    writes the block back to the local tier."""
    def scenario(side):
        storage, files, local, vi = populated_local(side)
        remote = side.fsblockstore.FSBlockStore(storage, "remote2")
        upsync(side, storage, "src", remote, target_chunk_size=2048,
               workers=2)
        fresh_local = side.fsblockstore.FSBlockStore(storage, "cache2")
        cache = side.cacheblockstore.CacheBlockStore(fresh_local, remote)
        idx = cache.get_existing_content(vi.chunk_hashes)
        h = int(idx.block_hashes[0])
        blk = cache.get_stored_block(h)
        cache.flush()    # drain the write-back
        got = fresh_local.get_stored_block(h)
        assert got.to_bytes() == blk.to_bytes()
        return covered(vi, idx), block_hashes(idx), got.to_bytes()

    assert same(scenario)[0]


def test_preflight_warms_both_tiers():
    def scenario(side):
        storage, files, local, vi = populated_local(side)
        seen = {}

        class Spy:
            def __init__(self, inner, name):
                self._i, self._n = inner, name

            def preflight_get(self, hashes):
                seen[self._n] = list(hashes)
                return self._i.preflight_get(hashes)

            def __getattr__(self, a):
                return getattr(self._i, a)

        cache = side.cacheblockstore.CacheBlockStore(
            Spy(local, "local"),
            Spy(side.fsblockstore.FSBlockStore(storage, "r3"), "remote"))
        cache.preflight_get([1, 2, 3])
        cache.flush()
        return seen

    assert same(scenario) == {"local": [1, 2, 3], "remote": [1, 2, 3]}


# ---------------------------------------------------------------------------
# PrefetchBlockStore and ShareBlockStore (test_prefetch.py)
# ---------------------------------------------------------------------------

def slow_store(side, latency=0.0):
    """An in-memory store of 64-byte blocks with a per-get latency and a
    probe of how many gets run at once, over ``side``'s block types."""
    fmt = side.store_index

    class SlowStore(side.blockstore.BlockStoreBase):
        def __init__(self):
            super().__init__()
            self.blocks = {}
            self.inflight = 0
            self.max_inflight = 0
            self.gets = []
            self._l = threading.Lock()

        def add(self, h, payload=b"x" * 64):
            bi = fmt.BlockIndex(block_hash=h, hash_identifier=1, tag=0,
                                chunk_hashes=np.array([h], np.uint64),
                                chunk_sizes=np.array([len(payload)],
                                                     np.uint32))
            self.blocks[h] = fmt.StoredBlock(block_index=bi,
                                             block_data=payload)

        def get_stored_block(self, block_hash):
            with self._l:
                self.gets.append(int(block_hash))
                self.inflight += 1
                self.max_inflight = max(self.max_inflight, self.inflight)
            time.sleep(latency)
            with self._l:
                self.inflight -= 1
            return self.blocks[int(block_hash)]

        def flush(self):
            pass

    return SlowStore()


def got_hashes(blocks) -> list:
    return [int(b.block_index.block_hash) for b in blocks]


def test_prefetch_overlaps_fetch_latency():
    """preflight_get starts the fetches at once: more than one get is in
    flight (the JAX test's counter; it also bounds the wall, which six
    workers sharing the machine make no measure of overlap)."""
    def scenario(side):
        inner = slow_store(side, latency=0.05)
        hashes = list(range(1, 17))
        for h in hashes:
            inner.add(h)
        store = side.prefetchblockstore.PrefetchBlockStore(inner, workers=8)
        store.preflight_get(np.array(hashes, np.uint64))
        got = got_hashes(store.get_stored_block(h) for h in hashes)
        return got, inner.max_inflight > 1, sorted(inner.gets)

    got, overlapped, gets = same(scenario)
    assert got == gets == list(range(1, 17)) and overlapped


def test_prefetch_residency_bound():
    def scenario(side):
        inner = slow_store(side)
        hashes = list(range(1, 101))
        for h in hashes:
            inner.add(h)
        store = side.prefetchblockstore.PrefetchBlockStore(
            inner, workers=4, max_resident=8)
        store.preflight_get(np.array(hashes, np.uint64))
        time.sleep(0.2)  # let the workers run to the residency cap
        done = sum(1 for f in store._futures.values() if f.done())
        got = got_hashes(store.get_stored_block(h) for h in hashes)
        return done <= 8, got, sorted(inner.gets)

    bounded, got, gets = same(scenario)
    assert bounded and got == gets == list(range(1, 101))


def test_unprefetched_get_falls_through():
    def scenario(side):
        inner = slow_store(side)
        inner.add(7)
        store = side.prefetchblockstore.PrefetchBlockStore(inner)
        return got_hashes([store.get_stored_block(7)]), inner.gets

    assert same(scenario) == ([7], [7])


def test_flush_cancels_undelivered():
    def scenario(side):
        inner = slow_store(side, latency=0.01)
        for h in range(1, 40):
            inner.add(h)
        store = side.prefetchblockstore.PrefetchBlockStore(
            inner, workers=2, max_resident=4)
        store.preflight_get(np.arange(1, 40, dtype=np.uint64))
        store.flush()
        left = len(store._futures)
        return left, got_hashes([store.get_stored_block(5)])

    assert same(scenario) == (0, [5])


def test_share_store_coalesces_concurrent_gets():
    """16 threads getting one block make one backing fetch; a get after
    it completes fetches again."""
    def scenario(side):
        inner = slow_store(side)
        inner.add(42)
        calls = []
        arrived = threading.Event()
        orig = inner.get_stored_block

        def counting_get(h):
            # hold the backing fetch open until every thread waits on it
            calls.append(h)
            assert arrived.wait(timeout=30)
            return orig(h)

        inner.get_stored_block = counting_get
        store = side.shareblockstore.ShareBlockStore(inner)
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = [pool.submit(store.get_stored_block, 42)
                    for _ in range(16)]
            deadline = time.time() + 30
            while time.time() < deadline:
                with store._lock:
                    req = store._in_flight.get(42)
                    n = len(req.event._cond._waiters) if req else 0
                if calls and n >= 15:
                    break
                time.sleep(0.002)
            arrived.set()
            results = got_hashes(f.result() for f in futs)
        fetches = len(calls)
        store.get_stored_block(42)
        return fetches, results, len(calls)

    assert same(scenario) == (1, [42] * 16, 2)


def test_share_store_propagates_errors_to_all_waiters():
    def scenario(side):
        inner = slow_store(side, latency=0.05)  # 99 never added: KeyError
        store = side.shareblockstore.ShareBlockStore(inner)

        def attempt(_):
            try:
                store.get_stored_block(99)
                return None
            except KeyError as e:
                return type(e).__name__, e.args

        with ThreadPoolExecutor(max_workers=8) as pool:
            return list(pool.map(attempt, range(8)))

    assert same(scenario) == [("KeyError", (99,))] * 8


def test_in_order_drain_never_wedges():
    """In-order drain with a residency cap of 2 and more workers than
    permits (the shape that once deadlocked) delivers every block."""
    def scenario(side):
        out = []

        def drain_all():
            for _ in range(15):
                inner = slow_store(side, latency=0.0005)
                hashes = list(range(1, 41))
                for h in hashes:
                    inner.add(h)
                store = side.prefetchblockstore.PrefetchBlockStore(
                    inner, workers=4, max_resident=2)
                store.preflight_get(np.array(hashes, np.uint64))
                out.append(got_hashes(store.get_stored_block(h)
                                      for h in hashes))

        t = threading.Thread(target=drain_all, daemon=True)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "prefetch drain wedged"
        return out

    assert same(scenario) == [list(range(1, 41))] * 15


def test_lru_keeps_the_most_recent_blocks():
    """LRUBlockStore(max_count=2): which gets reach the backing store and
    what the wrapper counts, over a sequence that hits, evicts and
    misses."""
    def scenario(side):
        inner = slow_store(side)
        for h in (1, 2, 3):
            inner.add(h)
        store = side.lrublockstore.LRUBlockStore(inner, max_count=2)
        got = got_hashes(store.get_stored_block(h)
                         for h in (1, 2, 1, 3, 2, 1, 1))
        return got, inner.gets, store.get_stats().get_stored_block_count

    assert same(scenario) == ([1, 2, 1, 3, 2, 1, 1], [1, 2, 3, 2, 1], 7)


# ---------------------------------------------------------------------------
# BlockStoreStorage (test_blockstorestorage.py)
# ---------------------------------------------------------------------------

def stored_version(side, base):
    src = base / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(3)
    (src / "a.bin").write_bytes(rng.integers(0, 256, 70000,
                                             dtype=np.uint8).tobytes())
    (src / "sub" / "b.txt").write_bytes(b"hello block store storage\n" * 100)
    (src / "empty").write_bytes(b"")
    fs = side.storage.FSStorage()
    store = side.fsblockstore.FSBlockStore(fs, str(base / "store"))
    vi, _ = upsync(side, fs, str(src), store, target_chunk_size=2048,
                   compression_tag=side.C.COMPRESSION_TYPE_NONE)
    return src, store, vi


@pytest.fixture
def views(tmp_path):
    """Each package's BlockStoreStorage over its own upsync of one tree."""
    def make(side):
        src, store, vi = stored_version(side, tmp_path / side.name)
        return src, side.blockstorestorage.BlockStoreStorage(store, vi), vi
    return make


def test_walk_files_over_store_view(views):
    def scenario(side):
        src, view, vi = views(side)
        got = {p: s for p, s, _ in side.storage.walk_files(view, "")}
        want = {p: s for p, s, _ in side.storage.walk_files(
            side.storage.FSStorage(), str(src))}
        assert got == want
        return got, vi.to_bytes()

    same(scenario)


def test_ranged_reads_match_source(views):
    def scenario(side):
        src, view, _ = views(side)
        data = (src / "a.bin").read_bytes()
        got = [view.read("a.bin"), view.read("a.bin", offset=1000, size=5000),
               view.read("a.bin", offset=len(data) - 333),
               view.read("sub/b.txt"), view.read("empty")]
        assert got == [data, data[1000:6000], data[-333:],
                       (src / "sub" / "b.txt").read_bytes(), b""]
        return got

    same(scenario)


def test_protocol_surface(views):
    def scenario(side):
        _, view, _ = views(side)
        out = [view.is_dir(""), view.is_dir("sub"), view.is_dir("a.bin"),
               view.exists("sub/b.txt"), view.exists("nope"),
               view.get_size("empty"), view.get_permissions("a.bin") > 0,
               sorted(view.list_dir(""))]
        for call in (lambda: view.write("x", b"data"),
                     lambda: view.remove_file("a.bin")):
            with pytest.raises(PermissionError) as ei:
                call()
            out.append(type(ei.value).__name__)
        return out

    assert same(scenario) == [True, True, False, True, False, 0, True,
                              ["a.bin", "empty", "sub"],
                              "PermissionError", "PermissionError"]
