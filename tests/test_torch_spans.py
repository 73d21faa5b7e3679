"""The port's timed spans (``longtail_tpu_torch.utils.monitor``): off
while no monitor is installed, nesting and CPU time, the bounded buffer,
every span of an upsync and a downsync on the CPU under its request and
parent with its count, the interpreter-lock wait probe's thread and
spans, and the span clock against ``torch.profiler``'s."""

import collections
import json
import os
import subprocess
import sys
import threading
import time
import types

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

# every span the port records but the probe's
NAMES = {"upsync", "downsync", "index", "index.read_wait", "index.stage",
         "index.plan", "index.card_wait", "index.small_wait",
         "index.asset_hash", "index.asset_hash.batch", "write", "write.put",
         "write.put_wait", "codec.upload", "codec.card_wait",
         "codec.assemble", "change", "change.decode", "write.assemble",
         "codec.launch", "codec.anchors_decode", "codec.frame", "store.put",
         "change.fetch", "change.scatter", "change.prepare"}
GIL_WAIT = "host.gil_wait"


def _program(spans):
    """The spans but the interpreter-lock wait probe's, which any test may
    record where the host is busy."""
    return [s for s in spans if s.name != GIL_WAIT]


def _probes():
    return [t for t in threading.enumerate()
            if t.name == "longtail-gil-probe"]


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
    # one shared no-op: nothing is made while off, and no probe runs
    assert monitor.span("a") is monitor.span("b") is monitor._OFF
    assert _probes() == []
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
    by = {s.name: s for s in _program(monitor.spans())}
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


def test_buffer_drops_oldest_and_counts(monkeypatch, recording):
    # the probe records nothing here, whatever the host's load
    monkeypatch.setattr(monitor, "PROBE_FLOOR_NS", 1 << 62)
    monitor.clear_spans()
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
    assert [s.name for s in _program(monitor.spans())] == ["a"]  # kept
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


@pytest.fixture(scope="module")
def round_trip():
    """The spans of two upsyncs and two downsyncs on the CPU, the second
    pair a new version downsynced over the first (the target re-index),
    with what the tests hold them to."""
    rng = np.random.default_rng(5)
    src = MemStorage()
    _tree(src, rng)
    store = _store()
    monitor.set_monitor(monitor.Monitor())
    try:
        vi, _ = api.upsync(src, "src", store, **_KW)
        backing = store.backing
        stored = sum(len(backing.get_stored_block(int(h)).block_data)
                     for h in backing._get_index().block_hashes)
        out = MemStorage()
        api.downsync(store, out, "out", vi, workers=4, device="cpu")
        src.write("src/big1",
                  rng.integers(0, 256, 400_000, np.uint8).tobytes())
        vi2, _ = api.upsync(src, "src", store, **_KW)
        api.downsync(store, out, "out", vi2, workers=4, device="cpu")
    finally:
        monitor.set_monitor(None)
    return types.SimpleNamespace(
        spans=_program(monitor.spans()), vi=vi, vi2=vi2,
        puts=store.get_stats().put_stored_block_count,
        put_bytes=backing.get_stats().put_stored_block_byte_count,
        stored=stored)


def test_upsync_downsync_spans(round_trip):
    vi, vi2, puts = round_trip.vi, round_trip.vi2, round_trip.puts
    spans = round_trip.spans
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
    s, = _program(monitor.spans())
    off = monitor.epoch_offset_ns()
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "probe")
    e0 = ev.start_ns()
    e1 = e0 + ev.duration_ns()
    assert s.t0_ns + off - 1_000_000 <= e0
    assert e1 <= s.t1_ns + off + 1_000_000
    assert e1 - e0 >= 2_000_000


def _parent_names(spans, name):
    by_id = {s.id: s for s in spans}
    return {by_id[s.parent].name for s in spans if s.name == name}


def test_write_and_change_steps_nest_with_their_counts(round_trip):
    """The steps inside write.put, write and change: each under its
    parent, each with the count it names."""
    spans = round_trip.spans
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent == 0]
    main = roots[0].thread
    for name in ("codec.launch", "codec.anchors_decode", "codec.frame",
                 "store.put"):
        assert _parent_names(spans, name) == {"write.put"}, name
    for name in ("write.assemble", "write.put"):
        assert _parent_names(spans, name) == {"write"}, name
    for name in ("change.fetch", "change.decode", "change.scatter",
                 "change.prepare"):
        assert _parent_names(spans, name) == {"change"}, name
    for s in spans:
        p = by_id.get(s.parent)
        if s.name in ("codec.launch", "codec.frame"):
            assert s.n == p.n > 0          # the block's raw bytes
        if s.name in ("codec.launch", "codec.anchors_decode",
                      "codec.frame", "store.put", "write.assemble",
                      "change.fetch", "change.scatter"):
            assert s.thread != main, s.name
        if s.name == "change.prepare":
            assert s.thread == main and s.n == 0
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    assert sum(s.n for s in spans if s.name == "codec.anchors_decode") > 0
    # store.put counts the bytes of each block file it writes
    assert sum(s.n for s in spans if s.name == "store.put") == \
        round_trip.put_bytes > 0
    for r in (s for s in roots if s.name == "upsync"):
        write, = (s for s in spans if s.name == "write"
                  and s.request == r.id)
        mine = [s for s in spans if s.request == r.id]
        assert sum(s.n for s in mine if s.name == "write.assemble") == \
            sum(s.n for s in mine if s.name == "write.put") == write.n
    changes = [s for s in spans if s.name == "change"]
    assert len(changes) == 2
    for c in changes:
        mine = [s for s in spans if s.request == c.request]
        # the scatters write every byte the change writes
        assert sum(s.n for s in mine if s.name == "change.scatter") == c.n
        prepare, = (s for s in mine if s.name == "change.prepare")
        fetched = [s for s in mine if s.name == "change.fetch"]
        assert fetched and prepare.t1_ns <= min(s.t0_ns for s in fetched)
    # the first downsync fetches every block the store held: their
    # stored bytes
    first = [s for s in spans if s.request == changes[0].request]
    assert sum(s.n for s in first if s.name == "change.fetch") == \
        round_trip.stored


def test_write_put_children_leave_little_unnamed(round_trip):
    """The steps inside write.put cover all but under 10% of its wall."""
    spans = round_trip.spans
    puts = {s.id: s for s in spans if s.name == "write.put"}
    wall = sum(s.t1_ns - s.t0_ns for s in puts.values())
    named = sum(s.t1_ns - s.t0_ns for s in spans if s.parent in puts)
    assert puts and named <= wall
    assert wall - named < 0.10 * wall


def test_probe_runs_exactly_while_a_monitor_is_installed():
    monitor.set_monitor(None)
    assert _probes() == []
    monitor.set_monitor(monitor.Monitor())
    try:
        probe, = _probes()
        assert probe.daemon and probe.is_alive()
        monitor.set_monitor(monitor.Monitor())     # still one recording
        assert _probes() == [probe]
    finally:
        monitor.set_monitor(None)
    # cleared: the probe was stopped and joined
    assert not probe.is_alive() and _probes() == []


def test_probe_records_the_wait_for_the_interpreter_lock(recording):
    """A thread that holds the interpreter lock for ten probe periods
    keeps the probe from running: the probe records root host.gil_wait
    spans of at least the floor, from its due time to its wake, inside
    that time."""
    with monitor.span("busy"):
        t0 = time.perf_counter_ns()
        while time.perf_counter_ns() - t0 < 10 * monitor.PROBE_PERIOD_NS:
            pass
    busy, = _program(monitor.spans())
    waits = [s for s in monitor.spans() if s.name == GIL_WAIT]
    assert len(waits) >= 2
    for s in waits:
        assert s.parent == 0 and s.request == s.id and s.cpu_ns == 0
        assert s.t1_ns - s.t0_ns >= monitor.PROBE_FLOOR_NS
        assert s.thread != busy.thread
    inside = sum(max(0, min(s.t1_ns, busy.t1_ns) - max(s.t0_ns, busy.t0_ns))
                 for s in waits)
    assert inside >= 2 * monitor.PROBE_FLOOR_NS
