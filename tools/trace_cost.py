#!/usr/bin/env python3
"""What recording costs a benchmark cell's job: job walls with a monitor
installed (the port's spans and the interpreter-lock wait probe, as a
``--trace 1`` run records them) against walls with none, in one process.

    python3 tools/trace_cost.py --workload <cell> --seed <n>
                                [--rounds 4] [--periods-ms P,...]
                                [--device cuda|cpu] [--tiny]

Runs the cell's set-up (``ltbench/jobs.py``) and one untimed job, then
``rounds`` rounds; in each, for every probe period of ``--periods-ms``
(default: the program's own; 0 records the spans with no probe), four
jobs: off, on, on, off, so that both sides run as many jobs of each
direction of a patch.  Prints one JSON object with, for each period,
the walls of its jobs on and of the jobs off beside them, their medians,
``on_over_off`` (the ratio of the medians), and per job on: the spans it
recorded by name (count, summed wall and thread CPU seconds), the probe's
``host.gil_wait`` share of its wall, the mean wait of a late wake, and
the spans the buffer dropped (0 where every span was kept).
``--device cpu --tiny`` rehearses it on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from longtail_tpu_torch.utils import monitor  # noqa: E402
from ltbench import run as lt_run  # noqa: E402
from ltbench.jobs import Jobs  # noqa: E402

from tools.idle_by_span import card  # noqa: E402

GIL_WAIT = "host.gil_wait"


class _NoProbe:
    """Stands in for the probe where a period of 0 asks for none."""

    def join(self) -> None:
        pass


def _install(period_ms: float) -> None:
    if period_ms:
        monitor.PROBE_PERIOD_NS = int(period_ms * 1e6)
        monitor.set_monitor(monitor.Monitor())
        return
    real = monitor._Probe
    monitor._Probe = _NoProbe
    try:
        monitor.set_monitor(monitor.Monitor())
    finally:
        monitor._Probe = real


def _recorded(wall_s: float) -> dict:
    spans = monitor.spans()
    waits = [s.t1_ns - s.t0_ns for s in spans if s.name == GIL_WAIT]
    steps: dict = collections.defaultdict(lambda: [0, 0, 0])
    for s in spans:
        got = steps[s.name]
        got[0] += 1
        got[1] += s.t1_ns - s.t0_ns
        got[2] += s.cpu_ns
    return {"spans": {k: {"n": n, "wall_s": w / 1e9, "cpu_s": c / 1e9}
                      for k, (n, w, c) in steps.items()},
            "gil_wait_pct": 100.0 * sum(waits) / 1e9 / wall_s,
            "late_wake_ms": sum(waits) / len(waits) / 1e6 if waits
            else None,
            "dropped": monitor.dropped_since(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/trace_cost.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--periods-ms", default=str(monitor.PROBE_PERIOD_NS
                                                / 1e6))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the benchmark's small tree (rehearsals)")
    args = ap.parse_args(argv)
    periods = [float(p) for p in args.periods_ms.split(",")]
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("trace_cost: no CUDA card", file=sys.stderr)
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
    by_period = {p: {"off": [], "on": [], "on_jobs": []} for p in periods}
    own = monitor.PROBE_PERIOD_NS
    scratch = tempfile.mkdtemp(prefix="trace-cost-")
    try:
        jobs = Jobs(found["cfg"], traffic, args.seed, args.device, scratch,
                    None, spec)
        jobs.setup()
        jobs.job(0)
        k = 1
        for _ in range(args.rounds):
            for p in periods:
                for side in ("off", "on", "on", "off"):
                    jobs.before(k)
                    if side == "on":
                        _install(p)
                    t0 = time.perf_counter()
                    try:
                        jobs.job(k)
                        if cuda:
                            torch.cuda.synchronize()
                    finally:
                        t1 = time.perf_counter()
                        monitor.set_monitor(None)
                        monitor.PROBE_PERIOD_NS = own
                    by_period[p][side].append(t1 - t0)
                    if side == "on":
                        by_period[p]["on_jobs"].append(_recorded(t1 - t0))
                    k += 1
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    out = {}
    for p, got in by_period.items():
        med = {side: statistics.median(got[side]) for side in ("off", "on")}
        out[str(p)] = {**got, "median": med,
                       "on_over_off": med["on"] / med["off"]}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": card(),
        "floor_ns": monitor.PROBE_FLOOR_NS, "periods_ms": out}, indent=1),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
