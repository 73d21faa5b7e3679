"""Shares of the program's own spans (``ltbench/program_spans.py``'s
window) that the per-layer metrics of ``ltbench/metrics/`` read besides
walls and rates: the off-CPU share of a step, the part of a step that
none of its children covers, and the part of one step's time that falls
inside another's.  Each returns None where the spans it reads are absent
or the buffer dropped one during the window."""

from __future__ import annotations

from ltbench import program_spans


def offcpu_pct(ctx, name: str):
    """Share (%) of the ``name`` spans' wall that their threads spent off
    the CPU (the wall less the thread's CPU time)."""
    spans = program_spans.window(ctx)
    if spans is None:
        return None
    hits = [s for s in spans if s.name == name]
    wall = program_spans.wall(hits, name)
    if not wall:
        return None
    return 100.0 * sum(s.t1_ns - s.t0_ns - s.cpu_ns for s in hits) / wall


def unnamed_pct(ctx, name: str, child: str):
    """Share (%) of the ``name`` spans' wall that none of their direct
    children covers; None where no ``child`` span (one that names the
    step to split) was recorded."""
    spans = program_spans.window(ctx)
    if spans is None or not any(s.name == child for s in spans):
        return None
    outer = {s.id: s for s in spans if s.name == name}
    wall = program_spans.wall(outer.values(), name)
    if not wall:
        return None
    # a span's children open and close on its thread, one after another
    named = sum(s.t1_ns - s.t0_ns for s in spans if s.parent in outer)
    return 100.0 * (wall - named) / wall


def inside_pct(ctx, name: str, of: str):
    """Summed wall of the ``name`` spans that falls inside the ``of``
    spans, as a share (%) of the summed ``of`` wall."""
    spans = program_spans.window(ctx)
    if spans is None:
        return None
    hits = [s for s in spans if s.name == name]
    outer = [(s.t0_ns, s.t1_ns) for s in spans if s.name == of]
    total = sum(b - a for a, b in outer)
    if not hits or not total:
        return None
    got = sum(max(0, min(s.t1_ns, b) - max(s.t0_ns, a))
              for s in hits for a, b in outer)
    return 100.0 * got / total
