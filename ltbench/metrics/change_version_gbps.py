"""Patch apply rate: bytes written to the client folder (the monitor's
asset_write) over the summed wall of the window's change_version spans
(block fetch, host decode, writes)."""


def read(ctx):
    seconds = sum(s[2] - s[1] for s in ctx.spans if s[0] == "change_version")
    n = ctx.counters.get("asset_write_bytes", 0)
    return n / seconds / 1e9 if seconds and n else None
