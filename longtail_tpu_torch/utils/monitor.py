"""Global monitor tap: block/asset lifecycle events, and timed spans.

The reference exposes an experimental ``Longtail_Monitor`` struct of
callbacks invoked from the hot loops via macros (src/longtail.h:840-858,
src/longtail.c:745-760) — the CLI's --detailed-progress MiniFB grid is its
consumer (cmd/main.c:581).  This is the Python re-expression: a
module-global tap object whose methods are invoked (when set) at the same
lifecycle points; ``set_monitor(None)`` keeps the hot paths at one global
read + None check.

While a monitor is installed the program also records **spans**: named
steps with their start and end on ``time.perf_counter_ns()``, the
thread's CPU time over them and a count ``n`` of the bytes or items they
handled.  Each span carries its parent span and a request id, one per
call made from outside (``api.upsync``, ``api.downsync``,
``create_version_index``); ``carry`` takes both to the worker threads
that run a call's jobs.  Spans go to a bounded buffer that outlives the
recording (``spans``, ``dropped_since``, ``clear_spans``); adding
``epoch_offset_ns()`` to their times puts them on ``torch.profiler``'s
clock.  Recording never calls the installed monitor's methods, and with
no monitor installed a span costs one global read and a None check.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

_monitor = None


class Monitor:
    """Subclass and override what you need; every hook defaults to no-op.

    Mirrors the Longtail_Monitor hooks the pipelines call
    (src/longtail.h:840-858): block events carry the store-index block
    position, asset events the version-index asset position.
    """

    # -- version/store scope ------------------------------------------------
    def version_begin(self, asset_count: int, chunk_count: int) -> None: ...

    def version_end(self) -> None: ...

    # -- block lifecycle ----------------------------------------------------
    def block_prepare(self, block_index: int, block_hash: int) -> None: ...

    def block_load(self, block_index: int, block_hash: int,
                   byte_count: int) -> None: ...

    def block_load_complete(self, block_index: int,
                            block_hash: int) -> None: ...

    def block_compose(self, block_index: int, block_hash: int) -> None: ...

    def block_save(self, block_index: int, block_hash: int,
                   byte_count: int) -> None: ...

    def block_save_complete(self, block_index: int,
                            block_hash: int) -> None: ...

    # -- asset lifecycle ----------------------------------------------------
    def asset_write(self, asset_index: int, offset: int,
                    byte_count: int) -> None: ...


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

SPAN_CAPACITY = 1 << 16
# the interpreter-lock wait probe: its sleep and the least lateness kept.
# Each late wake makes the thread holding the lock hand it over, so the
# period is long beside the interpreter's 5 ms switch interval.
PROBE_PERIOD_NS = 20_000_000
PROBE_FLOOR_NS = 500_000


class Span(NamedTuple):
    name: str
    id: int
    parent: int        # 0 for a root span
    request: int       # the root span's id
    thread: int        # threading.get_ident()
    t0_ns: int         # time.perf_counter_ns()
    t1_ns: int
    cpu_ns: int        # the thread's CPU time over the span (0: recorded)
    n: int             # bytes or items handled


class _Buffer:
    """The spans of one recording, oldest dropped past the capacity."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.spans: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.last_drop_ns = 0
        self.lock = threading.Lock()
        self.epoch_offset_ns = time.time_ns() - time.perf_counter_ns()

    def add(self, s: Span) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
                self.last_drop_ns = time.perf_counter_ns()
            self.spans.append(s)


_buffer = _Buffer()
_recording: _Buffer | None = None     # _buffer while a monitor is installed
_ids = itertools.count(1)
# (request id, span id) of the span open in this context
_current: contextvars.ContextVar = contextvars.ContextVar(
    "longtail_span", default=None)


class _Off:
    """What ``span`` returns while nothing records: a no-op whose ``n``
    may be set."""

    __slots__ = ("n",)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("buf", "name", "n", "id", "parent", "request", "token",
                 "t0", "c0")

    def __init__(self, buf: _Buffer, name: str, n: int):
        self.buf, self.name, self.n = buf, name, n

    def __enter__(self):
        cur = _current.get()
        self.id = next(_ids)
        self.parent, self.request = (0, self.id) if cur is None \
            else (cur[1], cur[0])
        self.token = _current.set((self.request, self.id))
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> None:
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        _current.reset(self.token)
        self.buf.add(Span(self.name, self.id, self.parent, self.request,
                          threading.get_ident(), self.t0, t1, c1 - self.c0,
                          int(self.n)))


def span(name: str, n: int = 0):
    """A context manager timing one step; set ``.n`` on what it returns
    where the count is known only inside."""
    buf = _recording
    if buf is None:
        return _OFF
    return _Span(buf, name, n)


def now_ns() -> int:
    """time.perf_counter_ns() while recording, else 0 (no clock read)."""
    return 0 if _recording is None else time.perf_counter_ns()


def record(name: str, t0_ns: int, t1_ns: int, n: int = 0) -> None:
    """Record a span whose start was taken elsewhere (``now_ns``), as a
    child of the span open here; its CPU time is not known (0)."""
    buf = _recording
    if buf is None:
        return
    cur = _current.get()
    sid = next(_ids)
    parent, request = (0, sid) if cur is None else (cur[1], cur[0])
    buf.add(Span(name, sid, parent, request, threading.get_ident(),
                 int(t0_ns), int(t1_ns), 0, int(n)))


def carry(fn):
    """fn bound to this thread's request and open span, to run on another
    thread (one call at a time: bind once per job); fn itself while
    nothing records."""
    if _recording is None:
        return fn
    ctx = contextvars.copy_context()

    def run(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)
    return run


def spans() -> list:
    """The spans of the current or last recording, oldest first."""
    buf = _buffer
    with buf.lock:
        return list(buf.spans)


def dropped_since(t_ns: int) -> int:
    """Spans dropped from the buffer, counted where the last drop came at
    or after t_ns (perf_counter ns): 0 means every span recorded since
    t_ns is still there."""
    buf = _buffer
    with buf.lock:
        return buf.dropped if buf.last_drop_ns >= t_ns else 0


def clear_spans() -> None:
    buf = _buffer
    with buf.lock:
        buf.spans.clear()
        buf.dropped = 0
        buf.last_drop_ns = 0


def epoch_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), sampled when the current
    or last recording started: added to a span's times, it puts them on
    torch.profiler's clock (nanoseconds since the epoch)."""
    return _buffer.epoch_offset_ns


class _Probe:
    """The interpreter-lock wait probe (see the module's docstring)."""

    def __init__(self):
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True,
                                       name="longtail-gil-probe")
        self.thread.start()

    def run(self) -> None:
        period = PROBE_PERIOD_NS / 1e9
        while not self.stop.is_set():
            due = time.perf_counter_ns() + PROBE_PERIOD_NS
            time.sleep(period)
            woke = time.perf_counter_ns()
            if woke - due >= PROBE_FLOOR_NS:
                record("host.gil_wait", due, woke)

    def join(self) -> None:
        self.stop.set()
        self.thread.join()


_probe: _Probe | None = None


def set_monitor(monitor: Monitor | None) -> None:
    """Install (or clear) the global monitor (Longtail_SetMonitor,
    src/longtail.c:762).  Spans are recorded exactly while one is
    installed; installing one where none was starts a new recording with
    an empty buffer and the interpreter-lock wait probe, clearing it
    stops the recording and joins the probe."""
    global _monitor, _buffer, _recording, _probe
    if monitor is not None and _recording is None:
        _buffer = _Buffer()
        _recording = _buffer
        _probe = _Probe()
    elif monitor is None:
        _recording = None
        if _probe is not None:
            _probe.join()
            _probe = None
    _monitor = monitor


def get_monitor() -> Monitor | None:
    return _monitor
