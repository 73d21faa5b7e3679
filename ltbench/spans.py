"""Spans and counters taken from the benchmark's side of the program's
entry points, kept in memory and read when the run ends.

Wrappers go around the names that ``longtail_tpu_torch.api`` calls
(``create_version_index``, ``write_content``, ``change_version``) and
around the block store's ``put_stored_block``; a ``Monitor`` installed
with ``set_monitor`` counts the bytes of blocks written and of target
writes.  With ``profile=True`` each span is also a
``torch.profiler.record_function`` range, so the profiler's trace can
say what the host was doing while the card was idle.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter

import torch

from longtail_tpu_torch.utils import monitor as lt_monitor

API_NAMES = ("create_version_index", "write_content", "change_version")
PREFIX = "ltbench."


class _Monitor(lt_monitor.Monitor):
    def __init__(self, rec: "Recorder"):
        self.rec = rec

    def block_save(self, block_index, block_hash, byte_count) -> None:
        self.rec.count("block_save_bytes", byte_count)
        self.rec.count("blocks_saved", 1)

    def asset_write(self, asset_index, offset, byte_count) -> None:
        self.rec.count("asset_write_bytes", byte_count)


class Recorder:
    """Spans (name, start, end, bytes) on the host's clock, and counters."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.spans: list = []
        self.counters: Counter = Counter()
        self._lock = threading.Lock()
        self._undo: list = []

    def count(self, key: str, n: int) -> None:
        with self._lock:
            self.counters[key] += int(n)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(PREFIX + name) if self.profile \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            box = [0]
            yield box
        t1 = time.perf_counter()
        with self._lock:
            self.spans.append((name, t0, t1, box[0]))

    def wrap(self, name: str, fn, nbytes=None):
        def wrapped(*args, **kwargs):
            with self.span(name) as box:
                out = fn(*args, **kwargs)
                if nbytes is not None:
                    box[0] = nbytes(args, out)
            return out
        return wrapped

    def install(self, api) -> None:
        """Wrap the api module's calls and set the monitor."""
        def indexed(_args, vi):
            return int(vi.asset_sizes.astype("u8").sum())

        for name in API_NAMES:
            fn = getattr(api, name)
            self._undo.append((api, name, fn))
            setattr(api, name, self.wrap(
                name, fn, indexed if name == "create_version_index"
                else None))
        lt_monitor.set_monitor(_Monitor(self))

    def wrap_store(self, store) -> None:
        """Span each put_stored_block of this store, with its raw bytes."""
        store.put_stored_block = self.wrap(
            "put_stored_block", store.put_stored_block,
            lambda args, _: len(args[0].block_data))

    def uninstall(self) -> None:
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)
        self._undo = []
        lt_monitor.set_monitor(None)

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.counters = Counter()
