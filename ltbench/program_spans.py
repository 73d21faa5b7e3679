"""The spans the program records itself (``longtail_tpu_torch.utils.
monitor``: on while a monitor is installed, as in a ``--trace 1`` run), as
the per-layer metrics of ``ltbench/metrics/`` read them.

Only spans that start inside one of the window's jobs count, so the
set-up's job and the profiled job are left out.  Every reader returns
None where the program records no spans (a program older than them),
where the buffer dropped one during the window, or where the span it
reads is absent.
"""

from __future__ import annotations

from longtail_tpu_torch.utils import monitor

MIB = 1 << 20


def window(ctx):
    """The spans that start inside one of ctx.jobs' intervals, or None."""
    read = getattr(monitor, "spans", None)
    if read is None or not ctx.jobs:
        return None
    jobs = [(int(t0 * 1e9), int(t1 * 1e9)) for t0, t1, _ in ctx.jobs]
    if monitor.dropped_since(min(t0 for t0, _ in jobs)):
        return None
    return [s for s in read()
            if any(t0 <= s.t0_ns < t1 for t0, t1 in jobs)]


def wall(spans, name: str) -> int:
    """Summed nanoseconds of the spans called name."""
    return sum(s.t1_ns - s.t0_ns for s in spans if s.name == name)


def index_pct(ctx, step: str, card: bool = False):
    """Summed wall of the ``step`` spans on each ``index`` span's own
    thread and inside it, as a share (%) of the summed ``index`` wall.
    card: the step waits on the card, which a CPU run has not."""
    spans = window(ctx)
    if spans is None or (card and ctx.platform == "cpu"):
        return None
    index = [s for s in spans if s.name == "index"]
    inside = [s for s in spans if s.name == step and any(
        s.thread == i.thread and i.t0_ns <= s.t0_ns < i.t1_ns
        for i in index)]
    total = wall(index, "index")
    if not inside or not total:
        return None
    return 100.0 * wall(inside, step) / total


def ms_per_mib(ctx, step: str, of: str = "write.put", card: bool = False):
    """Summed wall (ms) of the ``step`` spans per MiB that the ``of``
    spans handled (their ``n``)."""
    spans = window(ctx)
    if spans is None or (card and ctx.platform == "cpu"):
        return None
    mib = sum(s.n for s in spans if s.name == of) / MIB
    if not mib or not any(s.name == step for s in spans):
        return None
    return wall(spans, step) / 1e6 / mib
