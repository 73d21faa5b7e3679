"""Generic dependency-graph job executor — the Bikeshed counterpart.

The reference schedules everything through one JobAPI: a lock-free task
graph with dependency counts, two priority channels, EBUSY
suspend/resume, and first-error-cancels-the-group semantics
(lib/bikeshed/longtail_bikeshed.c:93-116, :240-270; capacity limits
:23-24; used from the core at src/longtail.c:959-1072 RunJobsBatched and
the v1 writer's channel-1 block readers :5159-5186).

This is the idiomatic-Python re-expression: named worker pools per
channel (I/O-bound phases get their own lane, like Bikeshed's channel 1
block readers), explicit dependency edges, and a `Suspend` return value
as the EBUSY analog — the job parks until `resume()` is called from an
async completion (e.g. a block store's put callback), then re-runs with
its payload.  The first exception cancels all unstarted jobs and
re-raises at `run()` (Bikeshed's `detected_error` propagation,
CHANGELOG.md:16-18).

Call sites that only need a flat fan-out keep using plain executors;
this graph is for overlapped pipelines with real dependencies
(fetch -> transform -> scatter with bounded in-flight state).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from longtail_tpu_torch.utils.monitor import carry


@dataclass
class Suspend:
    """EBUSY analog: the job parks; `register` receives a resume callable
    to invoke (once) when the awaited async completion fires.  The job
    function is then re-invoked with ``resumed=payload``."""

    register: Callable[[Callable[[Any], None]], None]


@dataclass
class _Job:
    fn: Callable
    channel: int
    deps_left: int = 0
    dependents: list = field(default_factory=list)
    done: bool = False
    result: Any = None
    suspended: bool = False


class JobGraph:
    """Build-then-run dependency graph.

    jobs = JobGraph(workers={0: 4, 1: 2})
    a = jobs.add(fa)
    b = jobs.add(fb, deps=[a], channel=1)
    jobs.run()          # raises the first job error, if any
    jobs.result(b)
    """

    def __init__(self, workers: dict[int, int] | int = 4):
        if isinstance(workers, int):
            workers = {0: workers}
        self._workers = workers
        self._jobs: list[_Job] = []
        self._lock = threading.Lock()
        self._ready: dict[int, deque] = {c: deque() for c in workers}
        self._cv = threading.Condition(self._lock)
        self._pending = 0
        self._active = 0      # jobs currently executing on a worker
        self._nsusp = 0       # jobs parked awaiting an async resume
        self._error: BaseException | None = None

    def add(self, fn: Callable, deps: list[int] | None = None,
            channel: int = 0) -> int:
        if channel not in self._workers:
            raise ValueError(f"no worker pool for channel {channel}")
        # the job runs under the request and span that added it
        j = _Job(fn=carry(fn), channel=channel)
        jid = len(self._jobs)
        self._jobs.append(j)
        for d in deps or []:
            dj = self._jobs[d]
            if not dj.done:
                dj.dependents.append(jid)
                j.deps_left += 1
        self._pending += 1
        if j.deps_left == 0:
            self._ready[channel].append(jid)
        return jid

    def result(self, jid: int):
        return self._jobs[jid].result

    def drop_result(self, jid: int) -> None:
        """Release a finished job's result reference — pipelines holding
        large payloads (block bytes) call this from the consuming job so
        in-flight memory stays bounded by the dependency window."""
        self._jobs[jid].result = None

    # -- execution --------------------------------------------------------

    def _complete(self, jid: int, result) -> None:
        with self._cv:
            j = self._jobs[jid]
            j.done = True
            j.result = result
            if j.suspended:
                self._nsusp -= 1
            j.suspended = False
            self._pending -= 1
            for d in j.dependents:
                dj = self._jobs[d]
                dj.deps_left -= 1
                if dj.deps_left == 0 and not dj.done:
                    self._ready[dj.channel].append(d)
            self._cv.notify_all()

    def _fail(self, err: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = err
            self._cv.notify_all()

    def _execute(self, jid: int, resumed=None) -> None:
        j = self._jobs[jid]
        try:
            if j.suspended:
                out = j.fn(resumed=resumed)
            else:
                out = j.fn()
        except BaseException as e:  # first error cancels the group
            self._fail(e)
            return
        if isinstance(out, Suspend):
            with self._cv:
                if not j.suspended:   # a re-suspend keeps its one count
                    self._nsusp += 1
                    j.suspended = True

            def resume(payload=None, _jid=jid):
                # re-run on the completion thread: the continuation is
                # the short tail of the job (the reference resumes the
                # parked task on a shed worker; here the async callback
                # thread plays that role)
                self._execute(_jid, resumed=payload)

            out.register(resume)
            return
        self._complete(jid, out)

    def _worker(self, channel: int) -> None:
        while True:
            with self._cv:
                while (not self._ready[channel] and self._pending > 0
                       and self._error is None):
                    # deadlock detection: pending jobs but nothing is
                    # running, nothing is parked awaiting a resume, and
                    # no channel has ready work -> the remaining jobs can
                    # never become ready.  Fail the group loudly instead
                    # of spinning forever.
                    if (self._active == 0 and self._nsusp == 0
                            and not any(self._ready.values())):
                        self._error = RuntimeError(
                            f"{self._pending} jobs can never become "
                            "ready (dependency cycle or orphaned "
                            "dependency)")
                        self._cv.notify_all()
                        break
                    self._cv.wait(0.05)
                if self._error is not None or (
                        self._pending == 0 and not self._ready[channel]):
                    return
                if not self._ready[channel]:
                    continue
                jid = self._ready[channel].popleft()
                self._active += 1
            try:
                self._execute(jid)
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()

    def run(self) -> None:
        """Run to completion; re-raises the first job error after
        stopping (unstarted jobs are abandoned, mirroring Bikeshed's
        detected_error early-out)."""
        threads = []
        for channel, n in self._workers.items():
            for _ in range(n):
                t = threading.Thread(
                    target=self._worker, args=(channel,), daemon=True)
                t.start()
                threads.append(t)
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        if self._pending:
            raise RuntimeError(
                f"{self._pending} jobs never became ready "
                "(dependency cycle or unresumed suspend)")
