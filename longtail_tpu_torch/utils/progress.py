"""Progress reporting (ProgressAPI src/longtail.h:498-502 + the rate-limited
wrapper lib/ratelimitedprogress/longtail_ratelimitedprogress.c)."""

from __future__ import annotations

import time


def null_progress(done: int, total: int) -> None:
    pass


class RateLimitedProgress:
    """Throttle progress callbacks to one per interval; always deliver the
    final (done == total) call."""

    def __init__(self, fn, interval_s: float = 0.2):
        self.fn = fn
        self.interval_s = interval_s
        self._last = 0.0

    def __call__(self, done: int, total: int) -> None:
        now = time.monotonic()
        if done >= total or (now - self._last) >= self.interval_s:
            self._last = now
            self.fn(done, total)
