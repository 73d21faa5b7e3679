"""The fault paths of tests/test_faults.py held between the JAX package
and the port: ENOSPC in downsync and upsync, a corrupt or truncated
store.lsi, cancellation, two writers through the .lsi lock and a missing
block file, each run in both packages from one seed with the same
exception (type and errno) and the same surviving state.  Also the short
source read, where the port raises and the JAX package writes an index
whose chunk sizes do not sum to its asset sizes, and the port's reader
thread, which ends when its consumer gives up."""

import errno
import threading

import numpy as np
import pytest
import torch

from tests.torch_sides import (
    JAX,
    PORT,
    block_hashes,
    downsync,
    same,
    upsync,
)

torch.set_num_threads(1)


def make_source(storage, root, n_files=6, seed=5):
    rng = np.random.default_rng(seed)
    storage.create_dir(root)
    for i in range(n_files):
        data = rng.integers(0, 256, size=int(rng.integers(2000, 30000)),
                            dtype=np.uint8).tobytes()
        storage.write(f"{root}/f{i}.bin", data)


class FailingStorage:
    """Delegating storage that raises ENOSPC from its write paths after
    ``budget`` successful writes (test_faults.py's fake)."""

    def __init__(self, side, inner, budget: int):
        self._error = side.storage.StorageError
        self._inner = inner
        self._budget = budget
        self._lock = threading.Lock()

    def _spend(self):
        with self._lock:
            if self._budget <= 0:
                raise self._error(errno.ENOSPC, "No space left on device",
                                  "injected")
            self._budget -= 1

    def write(self, path, data, offset=0):
        self._spend()
        return self._inner.write(path, data, offset)

    def write_ranges(self, path, size, ranges):
        self._spend()
        return self._inner.write_ranges(path, size, ranges)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def upsync_to_store(side, storage, target_block_size=8 << 20):
    make_source(storage, "src")
    store = side.compressblockstore.CompressBlockStore(
        side.fsblockstore.FSBlockStore(storage, "store"))
    vi, _ = upsync(side, storage, "src", store, target_chunk_size=2048,
                   target_block_size=target_block_size, workers=1)
    return store, vi


def outcome(excinfo) -> tuple:
    e = excinfo.value
    return type(e).__name__, getattr(e, "errno", None)


def files_of(storage, root, n=6) -> list:
    return [storage.read(f"{root}/f{i}.bin") for i in range(n)]


def test_disk_full_during_downsync_surfaces_enospc():
    def scenario(side):
        storage = side.storage.MemStorage()
        store, vi = upsync_to_store(side, storage)
        failing = FailingStorage(side, storage, budget=2)
        with pytest.raises(side.storage.StorageError) as ei:
            downsync(side, store, failing, "out", vi, workers=1)
        # the healthy storage still completes afterwards
        downsync(side, store, storage, "out_ok", vi, workers=1)
        assert files_of(storage, "out_ok") == files_of(storage, "src")
        return outcome(ei), vi.to_bytes(), files_of(storage, "out_ok")

    got = same(scenario)
    assert got[0] == ("StorageError", errno.ENOSPC)


def test_disk_full_during_upsync_surfaces_enospc():
    def scenario(side):
        storage = side.storage.MemStorage()
        make_source(storage, "src")
        failing = FailingStorage(side, storage, budget=1)
        store = side.compressblockstore.CompressBlockStore(
            side.fsblockstore.FSBlockStore(failing, "store"))
        with pytest.raises(side.storage.StorageError) as ei:
            upsync(side, storage, "src", store, target_chunk_size=2048,
                   workers=1)
        return outcome(ei)

    assert same(scenario) == ("StorageError", errno.ENOSPC)


@pytest.mark.parametrize("damage", ["corrupt", "truncated"])
def test_damaged_store_lsi_falls_back_to_scan(damage):
    """Garbage or half of store.lsi: a fresh store rebuilds its index by
    scanning the .lrb files (test_faults.py's corrupt and truncated
    cases), the same blocks in both packages."""
    def scenario(side):
        storage = side.storage.MemStorage()
        store, vi = upsync_to_store(side, storage)
        store.flush()
        blob = storage.read("store/store.lsi")
        storage.write("store/store.lsi", b"\xde\xad\xbe\xef" * 64
                      if damage == "corrupt" else blob[: len(blob) // 2])
        fresh = side.compressblockstore.CompressBlockStore(
            side.fsblockstore.FSBlockStore(storage, "store"))
        idx = fresh.get_existing_content(vi.chunk_hashes)
        assert idx.chunk_count >= vi.chunk_count
        downsync(side, fresh, storage, "out", vi, workers=1)
        assert files_of(storage, "out") == files_of(storage, "src")
        return blob, block_hashes(idx), files_of(storage, "out")

    same(scenario)


def test_cancel_mid_downsync_stops_work():
    """A pre-cancelled token aborts before writes; a token cancelled from
    a (rate-limited) progress callback stops mid-flight after the same
    progress calls in both packages."""
    def scenario(side):
        storage = side.storage.MemStorage()
        store, vi = upsync_to_store(side, storage, target_block_size=8192)
        Cancelled = side.cancel.Cancelled

        token = side.cancel.CancelToken()
        token.cancel()
        with pytest.raises(Cancelled) as first:
            downsync(side, store, storage, "out", vi, workers=1,
                     cancel_token=token)

        token2 = side.cancel.CancelToken()
        calls = []

        def cancelling_progress(done, total):
            calls.append((done, total))
            token2.cancel()

        with pytest.raises(Cancelled) as second:
            downsync(side, store, storage, "out2", vi, workers=1,
                     cancel_token=token2,
                     progress=side.progress.RateLimitedProgress(
                         cancelling_progress, 0.0))
        written = sorted(p for p, _, _ in side.storage.walk_files(
            storage, "out2"))
        return (type(first.value).__name__, type(second.value).__name__,
                calls, written)

    got = same(scenario)
    assert got[:2] == ("Cancelled", "Cancelled") and got[2]


def test_concurrent_flush_through_lsi_lock():
    """Two store instances over one backing store flush at once; the
    merged store.lsi holds both block sets and both versions come back
    from a cold store, with the same blocks in both packages."""
    def scenario(side):
        storage = side.storage.MemStorage()
        storage.create_dir("srcA")
        storage.create_dir("srcB")
        rng = np.random.default_rng(11)
        for root in ("srcA", "srcB"):
            for i in range(4):
                storage.write(f"{root}/{i}.bin",
                              rng.integers(0, 256, 20000, np.uint8).tobytes())
        stores = [side.compressblockstore.CompressBlockStore(
            side.fsblockstore.FSBlockStore(storage, "store"))
            for _ in range(2)]
        vis = [upsync(side, storage, root, st, target_chunk_size=2048,
                      workers=1)[0]
               for root, st in zip(("srcA", "srcB"), stores)]
        errs = []

        def flush(st):
            try:
                st.flush()
            except BaseException as e:  # noqa: BLE001 - reported below
                errs.append(e)

        threads = [threading.Thread(target=flush, args=(st,))
                   for st in stores]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "flush wedged on the .lsi lock"
        assert not errs
        disk = side.store_index.StoreIndex.from_bytes(
            storage.read("store/store.lsi"))
        on_disk = set(int(h) for h in disk.chunk_hashes)
        for vi in vis:
            assert all(int(h) in on_disk for h in vi.chunk_hashes), \
                "chunks lost in the .lsi merge"
        cold = side.compressblockstore.CompressBlockStore(
            side.fsblockstore.FSBlockStore(storage, "store"))
        for name, vi in zip(("outA", "outB"), vis):
            downsync(side, cold, storage, name, vi, workers=1)
        assert storage.read("outA/0.bin") == storage.read("srcA/0.bin")
        assert storage.read("outB/3.bin") == storage.read("srcB/3.bin")
        return (block_hashes(disk), sorted(on_disk),
                [vi.to_bytes() for vi in vis])

    same(scenario)


def test_missing_block_file_raises_clean_error():
    def scenario(side):
        storage = side.storage.MemStorage()
        store, vi = upsync_to_store(side, storage)
        store.flush()
        sub = storage.list_dir("store/chunks")[0]
        name = storage.list_dir(f"store/chunks/{sub}")[0]
        storage.remove_file(f"store/chunks/{sub}/{name}")
        fresh = side.compressblockstore.CompressBlockStore(
            side.fsblockstore.FSBlockStore(storage, "store"))
        with pytest.raises((side.storage.StorageError, FileNotFoundError,
                            KeyError)) as ei:
            downsync(side, fresh, storage, "out", vi, workers=1)
        return outcome(ei), name

    same(scenario)


# ---------------------------------------------------------------------------
# a source file that returns fewer bytes than its listing said
# ---------------------------------------------------------------------------

BIG = 9 << 20
CUT = 3 << 20


class ShortReads:
    """Delegating storage over a source whose ``big.bin`` was truncated
    after it was listed: of every read, the bytes past CUT come back
    halved.  ``branch`` picks the port's reader branch that sees it:
    "map" maps the file (through a whole-file read), "read" refuses the
    map, so the file is read part by part."""

    def __init__(self, side, inner, branch: str):
        self._side = side
        self._inner = inner
        self._branch = branch

    def read(self, path, offset=0, size=None):
        data = self._inner.read(path, offset, size)
        keep = max(0, CUT - offset)
        if path.endswith("big.bin") and len(data) > keep:
            data = data[:keep + (len(data) - keep) // 2]
        return data

    def map_file(self, path):
        if self._branch == "read":
            raise self._side.storage.StorageError(
                errno.ENOTSUP, "no map", path)
        return self._side.storage.MappedFile(memoryview(self.read(path)))

    def __getattr__(self, name):
        return getattr(self._inner, name)


def short_source(side, branch):
    storage = side.storage.MemStorage()
    storage.create_dir("src")
    rng = np.random.default_rng(23)
    storage.write("src/big.bin",
                  rng.integers(0, 256, BIG, dtype=np.uint8).tobytes())
    storage.write("src/small.bin",
                  rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
    return storage, ShortReads(side, storage, branch)


@pytest.fixture(scope="module")
def jax_short_index():
    """The JAX package's upsync of the short source, by reader branch."""
    out = {}

    def index(branch):
        if branch not in out:
            storage, source = short_source(JAX, branch)
            out[branch], _ = upsync(
                JAX, source, "src",
                JAX.fsblockstore.FSBlockStore(storage, "store"),
                target_chunk_size=1024, workers=2)
        return out[branch]
    return index


@pytest.mark.parametrize("branch", ["map", "read"])
@pytest.mark.parametrize("path", ["host", "cpu", "mesh"])
def test_short_source_read_raises_where_the_jax_package_indexes_it(
        jax_short_index, branch, path):
    """The port raises StorageError (EIO, naming the path, the offset and
    the bytes wanted and got) on the host path, the device path and the
    mesh; the JAX package indexes the same source silently, and its .lvi
    records asset sizes that its chunk sizes do not sum to."""
    vi = jax_short_index(branch)
    chunk_bytes = int(vi.chunk_sizes[vi.asset_chunk_indexes]
                      .astype(np.int64).sum())
    assert int(vi.asset_sizes.astype(np.int64).sum()) == BIG + 5000
    assert chunk_bytes != BIG + 5000

    storage, source = short_source(PORT, branch)
    kwargs = {"host": {"device": None}, "cpu": {"device": "cpu"},
              "mesh": {"device": "cpu", "mesh": ["cpu", "cpu"]}}[path]
    before = threading.active_count()
    with pytest.raises(PORT.storage.StorageError) as ei:
        upsync(PORT, source, "src",
               PORT.fsblockstore.FSBlockStore(storage, "store"),
               target_chunk_size=1024, workers=2, **kwargs)
    e = ei.value
    part = 1024 * 1024
    # the map holds CUT bytes and half of the rest; a read past CUT half
    first_short = (CUT + (BIG - CUT) // 2) // part * part \
        if branch == "map" else CUT
    assert e.errno == errno.EIO and e.filename == "src/big.bin"
    assert f"offset {first_short}:" in str(e) \
        and f"wanted {part} bytes" in str(e)
    assert not storage.exists("store/store.lsi")
    assert threading.active_count() == before


class FailingReads:
    """Delegating storage whose reads of ``big.bin`` from ``offset`` on
    raise EIO; it refuses maps, so the file is read part by part."""

    def __init__(self, side, inner, offset: int):
        self._error = side.storage.StorageError
        self._inner = inner
        self._offset = offset

    def read(self, path, offset=0, size=None):
        if path.endswith("big.bin") and offset >= self._offset:
            raise self._error(errno.EIO, "injected read error", path)
        return self._inner.read(path, offset, size)

    def map_file(self, path):
        raise self._error(errno.ENOTSUP, "no map", path)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_source_read_error_on_the_third_part():
    """A read error on a file's third part, after the port's reader
    thread has handed on the first two (the device path): the same
    StorageError in both packages, no block written, and no thread left
    behind."""
    def scenario(side):
        storage = side.storage.MemStorage()
        storage.create_dir("src")
        rng = np.random.default_rng(29)
        storage.write("src/big.bin",
                      rng.integers(0, 256, 5 << 20, dtype=np.uint8).tobytes())
        before = threading.active_count()
        with pytest.raises(side.storage.StorageError) as ei:
            upsync(side, FailingReads(side, storage, 2 << 20), "src",
                   side.fsblockstore.FSBlockStore(storage, "store"),
                   target_chunk_size=1024, workers=2)
        return (outcome(ei), ei.value.filename, storage.exists("store"),
                threading.active_count() - before)

    assert same(scenario) == (("StorageError", errno.EIO), "src/big.bin",
                              False, 0)


def test_reader_thread_ends_when_its_consumer_gives_up():
    """index_stream reads parts on a thread ahead of the batches; a
    consumer that stops after the first result leaves no reader blocked
    on the full queue."""
    from longtail_tpu_torch.parallel.pipeline import DevicePartIndexer

    ix = DevicePartIndexer(1024, torch.device("cpu"), batch_bytes=2 << 20)
    rng = np.random.default_rng(3)
    part = rng.integers(0, 256, ix.part_bytes, dtype=np.uint8)
    read = []

    def parts():
        for i in range(64):
            read.append(i)
            yield i, part

    before = threading.active_count()
    stream = ix.index_stream(parts(), prefetch_depth=2)
    tag, sizes, hashes = next(stream)
    assert tag == 0 and int(sizes.sum()) == ix.part_bytes
    assert threading.active_count() == before + 1
    stream.close()
    assert threading.active_count() == before
    assert len(read) < 64

