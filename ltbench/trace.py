"""One job under ``torch.profiler``: the card's busy intervals, device time
by kernel name, and the host spans open in each idle gap."""

from __future__ import annotations

import dataclasses

import torch

from ltbench.spans import PREFIX

JOB = PREFIX + "job"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    by_name: dict          # device op name -> seconds
    gaps: list             # (seconds, label), longest first

    def device_s(self, fragments) -> float:
        return sum(s for name, s in self.by_name.items()
                   if any(f in name for f in fragments))


def _ns(e, what: str) -> int:
    fn = getattr(e, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, what + "_us")() * 1000)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every traced event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        dur = _ns(e, "duration")
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), dev, start, start + dur))
    return out


def parse(prof) -> Trace | None:
    """The trace of the one job in prof, or None where it holds no device
    operation or no job span."""
    events = _events(prof)
    jobs = [e for e in events if e[0] == JOB and not e[1]]
    # a record_function range also shows on the device's timeline, as an
    # annotation that spans its kernels: not an operation
    dev = sorted((e for e in events if e[1] and not e[0].startswith(PREFIX)),
                 key=lambda e: e[2])
    if not jobs or not dev:
        return None
    w0, w1 = jobs[0][2], jobs[0][3]
    by_name: dict = {}
    merged = []
    for name, _, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    spans = [e for e in events if not e[1] and e[0].startswith(PREFIX)
             and e[0] != JOB]
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        open_ = sorted({n[len(PREFIX):] for n, _, a, b in spans
                        if a <= mid < b})
        gaps.append(((e - s) / 1e9, "+".join(open_) or "api"))
    gaps.sort(reverse=True)
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 by_name=by_name, gaps=gaps)


def profile(job, record) -> tuple:
    """Run job() once under the profiler; (its result, Trace or None)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record.span("job"):
            out = job()
            torch.cuda.synchronize()
    return out, parse(prof)
