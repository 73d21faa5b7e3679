"""The port's timed spans (``longtail_tpu_torch.utils.monitor``): off
while no monitor is installed, nesting and CPU time, the bounded buffer,
every span of an upsync and a downsync on the CPU under its request, and
the span clock against ``torch.profiler``'s."""

import collections
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from longtail_tpu_torch import api
from longtail_tpu_torch.formats import constants as C
from longtail_tpu_torch.ops import blake3
from longtail_tpu_torch.stores.compressblockstore import CompressBlockStore
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
from longtail_tpu_torch.stores.storage import MemStorage
from longtail_tpu_torch.utils import monitor

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every span the port records
NAMES = {"upsync", "downsync", "index", "index.read_wait", "index.stage",
         "index.plan", "index.card_wait", "index.small_wait",
         "index.asset_hash", "index.asset_hash.batch", "write", "write.put",
         "write.put_wait", "codec.upload", "codec.card_wait",
         "codec.assemble", "change", "change.decode"}


@pytest.fixture
def recording():
    monitor.set_monitor(monitor.Monitor())
    try:
        yield
    finally:
        monitor.set_monitor(None)


def test_off_records_nothing():
    monitor.set_monitor(None)
    monitor.clear_spans()
    with monitor.span("a", 3) as s:
        s.n = 4
        with monitor.span("b"):
            pass
    monitor.record("c", 1, 2)
    assert monitor.spans() == []
    # one shared no-op: nothing is made while off
    assert monitor.span("a") is monitor.span("b")
    assert monitor.now_ns() == 0
    fn = print
    assert monitor.carry(fn) is fn


def test_nesting_thread_time_and_threads(recording):
    seen = {}

    def work():
        with monitor.span("worker", 7):
            seen["thread"] = threading.get_ident()

    with monitor.span("outer") as outer:
        with monitor.span("inner"):
            sum(range(20000))
            t = threading.Thread(target=monitor.carry(work))
            t.start()
            t.join(30)
            assert not t.is_alive()
        outer.n = 11
    with monitor.span("second"):
        pass
    by = {s.name: s for s in monitor.spans()}
    assert set(by) == {"outer", "inner", "worker", "second"}
    o, i, w, s2 = by["outer"], by["inner"], by["worker"], by["second"]
    assert o.parent == 0 and o.request == o.id and o.n == 11
    assert i.parent == o.id and i.request == o.id
    assert w.parent == i.id and w.request == o.id and w.n == 7
    assert w.thread == seen["thread"] != o.thread
    assert s2.parent == 0 and s2.request == s2.id != o.id
    for s in by.values():
        assert 0 <= s.cpu_ns <= s.t1_ns - s.t0_ns
    assert o.t0_ns <= i.t0_ns <= i.t1_ns <= o.t1_ns


def test_buffer_drops_oldest_and_counts(recording):
    cap = monitor.SPAN_CAPACITY
    assert cap >= 65536
    t0 = time.perf_counter_ns()
    for k in range(cap + 10):
        monitor.record("r", k, k + 1, k)
    got = monitor.spans()
    assert len(got) == cap
    assert got[0].n == 10 and got[-1].n == cap + 9
    assert monitor.dropped_since(t0) == 10
    assert monitor.dropped_since(time.perf_counter_ns() + 10**9) == 0
    monitor.clear_spans()
    assert monitor.spans() == [] and monitor.dropped_since(0) == 0


def test_new_recording_starts_empty():
    monitor.set_monitor(monitor.Monitor())
    with monitor.span("a"):
        pass
    monitor.set_monitor(None)
    assert [s.name for s in monitor.spans()] == ["a"]   # kept after
    monitor.set_monitor(monitor.Monitor())
    try:
        assert monitor.spans() == []
    finally:
        monitor.set_monitor(None)


def _tree(storage, rng):
    """Three files on the device path (over the small-file cutoff), five
    on the host path."""
    storage.create_dir("src")
    words = rng.integers(0, 256, 4096, np.uint8)
    for i in range(3):
        storage.write(f"src/big{i}", np.concatenate([
            rng.integers(0, 256, 150_000, np.uint8), np.tile(words, 40),
            rng.integers(0, 256, 50_000 * (i + 1), np.uint8)]).tobytes())
    for i in range(5):
        storage.write(f"src/small{i}", rng.integers(
            0, 256, 300 + 900 * i, np.uint8).tobytes())


_KW = dict(target_chunk_size=4096, target_block_size=1 << 17,
           compression_tag=C.COMPRESSION_TYPE_LZ4_DEFAULT, workers=4,
           device="cpu")


def _store():
    return CompressBlockStore(FSBlockStore(MemStorage(), "store"),
                              device="cpu")


def test_upsync_downsync_spans(recording):
    rng = np.random.default_rng(5)
    src = MemStorage()
    _tree(src, rng)
    store = _store()
    vi, _ = api.upsync(src, "src", store, **_KW)
    out = MemStorage()
    api.downsync(store, out, "out", vi, workers=4, device="cpu")
    # a second version, downsynced over the first: the target re-index
    src.write("src/big1", rng.integers(0, 256, 400_000, np.uint8).tobytes())
    vi2, _ = api.upsync(src, "src", store, **_KW)
    api.downsync(store, out, "out", vi2, workers=4, device="cpu")
    puts = store.get_stats().put_stored_block_count

    spans = monitor.spans()
    names = NAMES if blake3._native() is not None \
        else NAMES - {"index.asset_hash.batch"}
    assert {s.name for s in spans} == names
    by_id = {s.id: s for s in spans}
    requests = collections.defaultdict(list)
    for s in spans:
        requests[s.request].append(s)
    roots = [by_id[r] for r in requests]
    assert [r.name for r in roots] == ["upsync", "downsync", "upsync",
                                      "downsync"]
    for r, members in requests.items():
        assert sum(s.parent == 0 for s in members) == 1
        for s in members:
            if s.parent:
                assert by_id[s.parent].request == r
    main = {r.thread for r in roots}
    assert len(main) == 1
    for s in spans:
        if s.name in ("write.put", "change.decode"):
            assert s.thread not in main
            assert by_id[s.parent].name in ("write", "change")
    ups = [r.request for r in roots if r.name == "upsync"]
    index = {s.request: s for s in spans if s.name == "index"}
    for r, v in zip(ups, (vi, vi2)):
        assert index[r].n == int(v.asset_sizes.sum())
    # the batch hashes every asset of each index, inside its asset hashing
    for s in spans:
        if s.name == "index.asset_hash.batch":
            outer = by_id[s.parent]
            assert outer.name == "index.asset_hash" and s.n == outer.n > 0
            assert outer.t0_ns <= s.t0_ns <= s.t1_ns <= outer.t1_ns
    batched = [s.n for s in spans if s.name == "index.asset_hash.batch"]
    if blake3._native() is not None:
        # both upsyncs, then the re-index of the client folder (vi's tree)
        assert batched == [vi.asset_count, vi2.asset_count, vi.asset_count]
    assert sum(s.name == "write.put" for s in spans) == puts
    for s in index.values():
        inner = sum(x.t1_ns - x.t0_ns for x in spans
                    if x.name.startswith("index.") and x.thread == s.thread
                    and x.name != "index.asset_hash.batch"   # nested
                    and s.t0_ns <= x.t0_ns < s.t1_ns)
        assert inner <= s.t1_ns - s.t0_ns


def test_no_native_records_no_batch():
    """Under LONGTAIL_TPU_NO_NATIVE (a fresh interpreter, so that no
    native library is cached) the assets are hashed one by one:
    index.asset_hash holds no batch child."""
    code = """
import json
import numpy as np
from longtail_tpu_torch import api
from longtail_tpu_torch.ops import blake3
from longtail_tpu_torch.stores.storage import MemStorage
from longtail_tpu_torch.utils import monitor
from tests.test_torch_spans import _KW, _store, _tree
assert blake3._native() is None
src = MemStorage()
_tree(src, np.random.default_rng(6))
monitor.set_monitor(monitor.Monitor())
vi, _ = api.upsync(src, "src", _store(), **_KW)
monitor.set_monitor(None)
print(json.dumps([vi.asset_count] + [[s.name, s.n] for s in monitor.spans()
                                     if s.name.startswith("index.asset")]))
"""
    env = dict(os.environ, PYTHONPATH=REPO, LONGTAIL_TPU_NO_NATIVE="1")
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env,
                         cwd=REPO, timeout=300, capture_output=True,
                         text=True).stdout
    count, *hashed = json.loads(out.strip().splitlines()[-1])
    assert hashed == [["index.asset_hash", count]] and count == 8


def test_span_on_the_profiler_clock(recording):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with monitor.span("outer"):
            with torch.profiler.record_function("probe"):
                time.sleep(0.002)
    s, = monitor.spans()
    off = monitor.epoch_offset_ns()
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "probe")
    e0 = ev.start_ns()
    e1 = e0 + ev.duration_ns()
    assert s.t0_ns + off - 1_000_000 <= e0
    assert e1 <= s.t1_ns + off + 1_000_000
    assert e1 - e0 >= 2_000_000
