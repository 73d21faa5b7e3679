"""Global monitor tap: block/asset lifecycle events.

The reference exposes an experimental ``Longtail_Monitor`` struct of 13
callbacks invoked from the hot loops via macros (src/longtail.h:840-858,
src/longtail.c:745-760) — the CLI's --detailed-progress MiniFB grid is its
consumer (cmd/main.c:581).  This is the Python re-expression: a
module-global tap object whose methods are invoked (when set) at the same
lifecycle points; ``set_monitor(None)`` keeps the hot paths at one global
read + None check.
"""

from __future__ import annotations

_monitor = None


class Monitor:
    """Subclass and override what you need; every hook defaults to no-op.

    Mirrors Longtail_Monitor (src/longtail.h:840-858):
    block events carry the store-index block position, asset events the
    version-index asset position.
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
    def asset_open(self, asset_index: int, path: str) -> None: ...

    def asset_read(self, asset_index: int, offset: int,
                   byte_count: int) -> None: ...

    def asset_write(self, asset_index: int, offset: int,
                    byte_count: int) -> None: ...

    def asset_close(self, asset_index: int) -> None: ...

    def chunks_hashed(self, chunk_count: int) -> None: ...


def set_monitor(monitor: Monitor | None) -> None:
    """Install (or clear) the global monitor (Longtail_SetMonitor,
    src/longtail.c:762)."""
    global _monitor
    _monitor = monitor


def get_monitor() -> Monitor | None:
    return _monitor
