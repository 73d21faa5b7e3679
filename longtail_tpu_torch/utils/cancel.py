"""Cooperative cancellation (CancelAPI src/longtail.h:102-109,
lib/atomiccancel/longtail_atomiccancel.c)."""

from __future__ import annotations

import threading


class Cancelled(Exception):
    """Raised when an operation observes a cancelled token (ECANCELED)."""


class CancelToken:
    def __init__(self):
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def is_cancelled(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        if self._event.is_set():
            raise Cancelled()


def check(token: CancelToken | None) -> None:
    if token is not None:
        token.check()
