"""Allocation tracker keyed by context string.

The reference's memtracer (lib/longtail/memtracer — lib/memtracer/
longtail_memtracer.c:32-78) hooks the global allocator via
Longtail_SetReAllocAndFree and keeps per-context-string count/mem/peak
stats plus a global peak, dumped as CSV + a human summary
(Longtail_MemTracer_DumpStats lib/memtracer/longtail_memtracer.c:122).

Python has no pluggable allocator seam, so this is the idiomatic
re-expression over ``tracemalloc``: ``install()`` starts tracing, and the
hot paths (or callers) wrap phases in ``with memtracer.context("name")``,
which attributes the *net* allocation delta and the in-scope peak to that
name.  The same CSV/summary surface is kept so tooling parity holds.
"""

from __future__ import annotations

import contextlib
import threading
import tracemalloc
from dataclasses import dataclass, field


@dataclass
class ContextStats:
    count: int = 0          # number of times the context was entered
    mem: int = 0            # net bytes attributed (sum of enter->exit deltas)
    peak: int = 0           # max in-scope traced peak observed


@dataclass
class _State:
    installed: bool = False
    contexts: dict = field(default_factory=dict)
    global_peak: int = 0
    depth: int = 0          # live context() nesting (see context docstring)
    lock: threading.Lock = field(default_factory=threading.Lock)


_state = _State()


def _sample_global_peak() -> None:
    """Fold the process-wide traced peak into global_peak so the reported
    number covers allocations *between* contexts too (the reference's
    memtracer tracks a process-wide peak, lib/memtracer/
    longtail_memtracer.c:32-78)."""
    if _state.installed:
        _, peak = tracemalloc.get_traced_memory()
        with _state.lock:
            _state.global_peak = max(_state.global_peak, peak)


def install() -> None:
    """Start allocation tracing (the Longtail_SetReAllocAndFree analog)."""
    if not _state.installed:
        tracemalloc.start()
        _state.installed = True


def uninstall() -> None:
    if _state.installed:
        _sample_global_peak()
        tracemalloc.stop()
        _state.installed = False


def installed() -> bool:
    return _state.installed


def reset() -> None:
    with _state.lock:
        _state.contexts.clear()
        _state.global_peak = 0
    if _state.installed:
        tracemalloc.reset_peak()


@contextlib.contextmanager
def context(name: str):
    """Attribute allocations inside the block to `name`.

    No-op (one attribute read) when the tracer is not installed, mirroring
    the reference's zero-cost default allocator path.

    Peak attribution resets the interpreter-wide traced peak, so it is only
    exact for the *outermost* context: nested or concurrent contexts share
    the outer window's peak (their `mem` deltas stay exact).  The global
    peak is additionally sampled at entry/exit and at dump/uninstall time,
    so it covers the whole traced run, not just wrapped phases.
    """
    if not _state.installed:
        yield
        return
    before, peak_before = tracemalloc.get_traced_memory()
    with _state.lock:
        _state.global_peak = max(_state.global_peak, peak_before)
        outermost = _state.depth == 0
        _state.depth += 1
    if outermost:
        tracemalloc.reset_peak()
    try:
        yield
    finally:
        current, peak = tracemalloc.get_traced_memory()
        with _state.lock:
            _state.depth -= 1
            st = _state.contexts.setdefault(name, ContextStats())
            st.count += 1
            st.mem += current - before
            st.peak = max(st.peak, peak)
            _state.global_peak = max(_state.global_peak, peak)


def stats(name: str) -> ContextStats:
    with _state.lock:
        return _state.contexts.get(name, ContextStats())


def global_peak() -> int:
    return _state.global_peak


def dump_stats(csv_path: str | None = None) -> str:
    """Human summary (returned); optionally write the per-context CSV the
    reference dumps (lib/memtracer/longtail_memtracer.c:122)."""
    _sample_global_peak()
    with _state.lock:
        rows = sorted(_state.contexts.items())
        gp = _state.global_peak
    lines = [f"{'context':<32} {'count':>8} {'net_mem':>12} {'peak':>12}"]
    for name, st in rows:
        lines.append(f"{name:<32} {st.count:>8} {st.mem:>12} {st.peak:>12}")
    lines.append(f"global peak: {gp}")
    if csv_path is not None:
        with open(csv_path, "w") as f:
            f.write("context;count;net_mem;peak\n")
            for name, st in rows:
                f.write(f"{name};{st.count};{st.mem};{st.peak}\n")
    return "\n".join(lines)
