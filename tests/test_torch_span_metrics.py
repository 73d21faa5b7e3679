"""The per-layer metrics that split ``write.put`` and ``change`` and read
the interpreter-lock wait probe (``ltbench/metrics/``), each on a span
list made by hand: the number it defines, and None where the span it
reads is absent (a program older than it) or the buffer dropped a span
during the window."""

import os
import types

import pytest

from longtail_tpu_torch.utils import monitor
from longtail_tpu_torch.utils.monitor import Span
from ltbench import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20
T = 10**9                 # the job starts 1 s into perf_counter's time
MS = 10**6


def _span(name, sid, parent, t0_ms, t1_ms, n=0, cpu_ms=None, thread=2):
    cpu = (t1_ms - t0_ms) if cpu_ms is None else cpu_ms
    return Span(name, sid, parent, 1, thread, T + int(t0_ms * MS),
                T + int(t1_ms * MS), int(cpu * MS), n)


def _build():
    """One upsync of 100 ms: a put of 2 MiB over 20 ms whose children
    cover 19 ms, two assemblies of 1 MiB and 4 ms, and 15 ms of the
    probe's waits inside the job (one runs 5 ms past its end)."""
    return [
        _span("upsync", 1, 0, 0, 100, thread=1),
        _span("write", 2, 1, 5, 90, 2 * MIB, thread=1),
        _span("write.assemble", 3, 2, 5, 9, MIB, thread=3),
        _span("write.assemble", 4, 2, 6, 10, MIB, thread=4),
        _span("write.put", 10, 2, 10, 30, 2 * MIB),
        _span("codec.upload", 11, 10, 10, 12),
        _span("codec.launch", 12, 10, 12, 18, 2 * MIB),
        _span("codec.card_wait", 13, 10, 18, 19),
        _span("codec.anchors_decode", 14, 10, 19, 20, 5000),
        _span("codec.assemble", 15, 10, 20, 24),
        _span("codec.frame", 16, 10, 24, 25, 2 * MIB),
        _span("store.put", 17, 10, 25, 29, MIB),
        Span("host.gil_wait", 20, 0, 20, 9, T + 40 * MS, T + 50 * MS, 0, 0),
        Span("host.gil_wait", 21, 0, 21, 9, T + 95 * MS, T + 105 * MS, 0,
             0),
    ]


def _patch():
    """One downsync of 100 ms: two blocks of 1 MiB, each fetched in 1 ms,
    decoded in 4 ms with 3 ms on the CPU, scattered in 5 ms with 1 ms on
    the CPU; 20 ms of the probe's waits."""
    return [
        _span("downsync", 1, 0, 0, 100, thread=1),
        _span("change", 2, 1, 50, 99, 2 * MIB, thread=1),
        _span("change.prepare", 3, 2, 50, 52, thread=1),
        _span("change.fetch", 4, 2, 52, 53, 700_000, thread=3),
        _span("change.fetch", 5, 2, 53, 54, 700_000, thread=4),
        _span("change.decode", 6, 2, 54, 58, MIB, cpu_ms=3),
        _span("change.decode", 7, 2, 58, 62, MIB, cpu_ms=3),
        _span("change.scatter", 8, 2, 62, 67, MIB, cpu_ms=1),
        _span("change.scatter", 9, 2, 67, 72, MIB, cpu_ms=1),
        Span("host.gil_wait", 20, 0, 20, 9, T + 10 * MS, T + 30 * MS, 0, 0),
    ]


# metric: (spans, the number it reads, the span whose absence reads None)
CASES = {
    "codec_launch_ms_per_mib": (_build, 3.0, "codec.launch"),
    "codec_anchors_decode_ms_per_mib": (_build, 0.5,
                                        "codec.anchors_decode"),
    "store_put_ms_per_mib": (_build, 2.0, "store.put"),
    "write_put_unnamed_pct": (_build, 5.0, "store.put"),
    "write_assemble_ms_per_mib": (_build, 4.0, "write.assemble"),
    "gil_wait_pct.upsync": (_build, 15.0, "host.gil_wait"),
    "change_fetch_ms_per_mib": (_patch, 1.0, "change.fetch"),
    "change_scatter_ms_per_mib": (_patch, 5.0, "change.scatter"),
    "change_scatter_offcpu_pct": (_patch, 80.0, "change.scatter"),
    "change_decode_offcpu_pct": (_patch, 25.0, "change.decode"),
    "gil_wait_pct.downsync": (_patch, 20.0, "host.gil_wait"),
}


def _read(monkeypatch, metric, spans, dropped=0):
    monkeypatch.setattr(run, "ROOT", REPO)
    monkeypatch.setattr(monitor, "spans", lambda: list(spans))
    monkeypatch.setattr(monitor, "dropped_since", lambda t: dropped)
    ctx = types.SimpleNamespace(jobs=[(T / 1e9, (T + 100 * MS) / 1e9, 1)],
                                platform="gpu")
    return run.reader(metric)(ctx)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reads_its_number(monkeypatch, metric):
    make, want, _ = CASES[metric]
    assert _read(monkeypatch, metric, make()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_absent_span_reads_none(monkeypatch, metric):
    make, _, needs = CASES[metric]
    spans = [s for s in make() if s.name != needs]
    assert _read(monkeypatch, metric, spans) is None
    assert _read(monkeypatch, metric, []) is None


@pytest.mark.parametrize("metric", sorted(CASES))
def test_dropped_span_reads_none(monkeypatch, metric):
    make = CASES[metric][0]
    assert _read(monkeypatch, metric, make(), dropped=1) is None


def test_each_is_a_listed_metric():
    listed = {m["name"]: m for m in run.load_json(
        os.path.join(REPO, "BENCHMARK.json"))["per_layer"]}
    for metric, (make, _, _) in CASES.items():
        m = listed[metric]
        cell = "lz4.build-upsync" if make is _build \
            else "lz4.patch-downsync"
        assert m["workloads"] == [cell] and m["source"] == "program_span"
