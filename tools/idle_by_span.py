#!/usr/bin/env python3
"""Where the card's idle time in one job of a benchmark cell goes, by the
program's own spans (``longtail_tpu_torch.utils.monitor``) put on
``torch.profiler``'s clock.

    python3 tools/idle_by_span.py --workload <cell> --seed <n>
                                  [--device cuda|cpu] [--tiny]

Runs the cell's set-up (``ltbench/jobs.py``) and one untimed job, then
one job under ``torch.profiler`` (CPU and CUDA) with a plain ``Monitor``
installed, and prints one JSON object:

- ``window_s``, ``idle_s``: the job's wall (its root span, ``upsync`` or
  ``downsync``) and the part of it in which no kernel, copy or memset ran;
- ``by_span``: that idle time by the innermost span open on the job's
  thread at each instant (``<root> (self)``: the root's own time), in
  seconds and as a share of ``idle_s``;
- ``workers``: inside ``write`` and ``change``, whose work runs on worker
  threads, the same idle time shared out at each instant equally over
  the worker steps open then: each block waiting for a put worker
  (``write.put_wait``) and each worker thread's innermost step (an
  assembler's ``write.assemble``; a put's ``codec.upload``,
  ``codec.launch``, ``codec.card_wait``, ``codec.anchors_decode``,
  ``codec.assemble``, ``codec.frame``, ``store.put``, and ``write.put
  (self)``: the rest of a put, which no span names; a patch's
  ``change.fetch``, ``change.decode``, ``change.scatter``); ``(none)``
  where no worker step is open (``change.prepare``, the main thread's
  work before the patch's job graph runs, is a span of its own);
- ``gil_wait``: the interpreter-lock wait probe's ``host.gil_wait``
  spans inside the job's wall, in seconds and as a share of the wall
  and of ``idle_s`` (the part of the idle in which the probe waited);
- ``clock_check``: ``card_wait_on_busy_pct``, the share of the
  ``index.card_wait`` and ``codec.card_wait`` wall that overlaps the
  card's busy intervals (low where the work waited for had ended before
  the wait began); ``probe``, a span around a ~25 ms spin kernel and
  the host's wait for it, traced alone: the share of its wall the card
  is busy (near 100% where the span clock and the card's line up) and
  the milliseconds from the span's start to the kernel's and from the
  kernel's end to the span's;
- ``probe_ns``: how far a ``record_function`` event's start lies after a
  ``time.time_ns()`` taken just before it (the profiler's clock is the
  epoch's where this is small).

``--device cpu --tiny`` rehearses the tool on the CPU: no device events,
so the whole job counts as idle and the clock check is null.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from longtail_tpu_torch.utils import monitor  # noqa: E402
from ltbench import run as lt_run  # noqa: E402
from ltbench.jobs import Jobs  # noqa: E402
from ltbench.trace import PREFIX, _events  # noqa: E402

ROOTS = ("upsync", "downsync")
SPREAD = ("write", "change")          # their work runs on worker threads
NESTED = ("write.assemble", "write.put", "codec.upload", "codec.launch",
          "codec.card_wait", "codec.anchors_decode", "codec.assemble",
          "codec.frame", "store.put", "change.fetch", "change.decode",
          "change.scatter")           # a worker thread's steps
GIL_WAIT = "host.gil_wait"
QUEUED = "write.put_wait"
CARD_WAITS = ("index.card_wait", "codec.card_wait")


def busy_intervals(events, w0: int, w1: int) -> list:
    """Merged [start, end] of the device's operations, clipped to
    [w0, w1] (ns, the profiler's clock)."""
    dev = sorted((s, e) for name, is_dev, s, e in events
                 if is_dev and not name.startswith(PREFIX))
    merged: list = []
    for s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def overlap(busy: list, starts: list, s: int, e: int) -> int:
    """Nanoseconds of [s, e] that the merged busy intervals (starting at
    starts) cover."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    got = 0
    for b0, b1 in busy[i:]:
        if b0 >= e:
            break
        got += max(0, min(b1, e) - max(b0, s))
    return got


def attribute(spans: list, root, busy: list) -> tuple:
    """(idle ns by the innermost span open on the root's thread, idle ns
    inside SPREAD spans by worker step) over the root's interval."""
    w0, w1 = root.t0_ns, root.t1_ns
    idle = []
    t = w0
    for b0, b1 in busy:
        if b0 > t:
            idle.append((t, b0))
        t = max(t, b1)
    if t < w1:
        idle.append((t, w1))
    edges = []
    for a, b in idle:
        edges += [(a, 1, "idle", None), (b, 0, "idle", None)]
    for s in spans:
        if s.request != root.request or s.t1_ns <= s.t0_ns:
            continue
        kind = "main" if s.thread == root.thread else "worker"
        edges += [(s.t0_ns, 1, kind, s), (s.t1_ns, 0, kind, s)]
    edges.sort(key=lambda x: (x[0], x[1]))
    is_idle = 0
    main: dict = {}
    worker: dict = {}
    by_span: dict = {}
    by_worker: dict = {}
    for k, (t, opening, kind, s) in enumerate(edges):
        if kind == "idle":
            is_idle += 1 if opening else -1
        else:
            opened = main if kind == "main" else worker
            if opening:
                opened[s.id] = s
            else:
                opened.pop(s.id, None)
        if k + 1 == len(edges) or not is_idle:
            continue
        dt = edges[k + 1][0] - t
        if dt <= 0 or not main:
            continue
        inner = max(main.values(), key=lambda x: (x.t0_ns, x.id))
        label = inner.name + " (self)" if inner.name in ROOTS \
            else inner.name
        by_span[label] = by_span.get(label, 0) + dt
        if inner.name not in SPREAD:
            continue
        items = [QUEUED for w in worker.values() if w.name == QUEUED]
        threads: dict = {}
        for w in worker.values():
            if w.name in NESTED:
                cur = threads.get(w.thread)
                if cur is None or (w.t0_ns, w.id) > (cur.t0_ns, cur.id):
                    threads[w.thread] = w
        items += [w.name + " (self)" if w.name == "write.put" else w.name
                  for w in threads.values()]
        share = by_worker.setdefault(inner.name, {})
        for item in items or ["(none)"]:
            share[item] = share.get(item, 0) + dt / max(len(items), 1)
    return by_span, by_worker


def gil_wait(spans: list, root, busy: list, idle: int) -> dict:
    """The probe's host.gil_wait time inside the root's wall, and the part
    of it in which the card was idle."""
    starts = [b[0] for b in busy]
    window = root.t1_ns - root.t0_ns
    got = on_busy = 0
    for s in spans:
        if s.name != GIL_WAIT:
            continue
        a, b = max(s.t0_ns, root.t0_ns), min(s.t1_ns, root.t1_ns)
        if b > a:
            got += b - a
            on_busy += overlap(busy, starts, a, b)
    return {"s": got / 1e9, "pct_of_window": 100.0 * got / window,
            "pct_of_idle": 100.0 * (got - on_busy) / idle if idle else None}


def table(ns: dict, total: int) -> dict:
    return {k: {"s": v / 1e9, "pct": 100.0 * v / total if total else None}
            for k, v in sorted(ns.items(), key=lambda kv: -kv[1])}


def clock_probe() -> int:
    """ns from a time.time_ns() to the start of a record_function event
    opened right after it."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t = time.time_ns()
        with torch.profiler.record_function("idle_by_span.probe"):
            pass
    return next(s for name, _, s, _ in _events(prof)
                if name == "idle_by_span.probe") - t


def card_probe() -> dict:
    """A span around a spin kernel and the wait for it, on the card's
    timeline (see ``clock_check`` above)."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    monitor.set_monitor(monitor.Monitor())
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with monitor.span("probe"):
                torch.cuda._sleep(50_000_000)
                torch.cuda.synchronize()
    finally:
        monitor.set_monitor(None)
    probe, = (s for s in monitor.spans() if s.name == "probe")
    off = monitor.epoch_offset_ns()
    a, b = probe.t0_ns + off, probe.t1_ns + off
    busy = busy_intervals(_events(prof), a, b)
    if not busy:
        return {"on_busy_pct": 0.0}
    return {"on_busy_pct": 100.0 * sum(e - s for s, e in busy) / (b - a),
            "lead_ms": (busy[0][0] - a) / 1e6,
            "tail_ms": (b - busy[-1][1]) / 1e6}


def card() -> dict:
    if not torch.cuda.is_available():
        return {"name": "cpu"}
    out = {"name": torch.cuda.get_device_name(0)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/idle_by_span.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the benchmark's small tree (rehearsals)")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("idle_by_span: no CUDA card", file=sys.stderr)
        return 2

    lt_run.ROOT = REPO
    found = lt_run.find_cell(lt_run.load_json("BENCHMARK.json"),
                             args.workload)
    traffic = dict(found["traffic"])
    spec = None
    if args.tiny:
        spec = lt_run.TINY
        if "patch" in traffic:
            traffic["patch"] = lt_run.TINY_PATCH
    probe = card_probe() if cuda else None
    scratch = tempfile.mkdtemp(prefix="idle-by-span-")
    try:
        jobs = Jobs(found["cfg"], traffic, args.seed, args.device, scratch,
                    None, spec)
        jobs.setup()
        jobs.job(0)
        jobs.before(1)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        monitor.set_monitor(monitor.Monitor())
        try:
            with torch.profiler.profile(activities=acts) as prof:
                jobs.job(1)
                if cuda:
                    torch.cuda.synchronize()
        finally:
            monitor.set_monitor(None)
        off = monitor.epoch_offset_ns()
        spans = [s._replace(t0_ns=s.t0_ns + off, t1_ns=s.t1_ns + off)
                 for s in monitor.spans()]
        events = _events(prof)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    root = max((s for s in spans if s.parent == 0 and s.name in ROOTS),
               key=lambda s: s.t1_ns - s.t0_ns)
    busy = busy_intervals(events, root.t0_ns, root.t1_ns)
    window = root.t1_ns - root.t0_ns
    idle = window - sum(e - s for s, e in busy)
    by_span, by_worker = attribute(spans, root, busy)
    waits = [s for s in spans if s.name in CARD_WAITS
             and s.request == root.request]
    wait_ns = sum(s.t1_ns - s.t0_ns for s in waits)
    starts = [b[0] for b in busy]
    covered = sum(overlap(busy, starts, s.t0_ns, s.t1_ns) for s in waits)
    out = {
        "workload": args.workload, "seed": args.seed, "card": card(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "window_s": window / 1e9, "idle_s": idle / 1e9,
        "device_events": sum(1 for e in events if e[1]),
        "spans": sum(1 for s in spans if s.request == root.request),
        "dropped": monitor.dropped_since(0),
        "by_span": table(by_span, idle),
        "workers": {k: table(v, sum(v.values()))
                    for k, v in by_worker.items()},
        "gil_wait": gil_wait(spans, root, busy, idle),
        "clock_check": {
            "card_wait_s": wait_ns / 1e9,
            "card_wait_on_busy_pct": 100.0 * covered / wait_ns
            if cuda and wait_ns else None,
            "probe": probe},
        "probe_ns": clock_probe(),
    }
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
