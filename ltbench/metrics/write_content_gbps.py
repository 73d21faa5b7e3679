"""Block writing rate: raw bytes of the blocks written (the monitor's
block_save) over the summed wall of the window's write_content spans."""


def read(ctx):
    seconds = sum(s[2] - s[1] for s in ctx.spans if s[0] == "write_content")
    n = ctx.counters.get("block_save_bytes", 0)
    return n / seconds / 1e9 if seconds and n else None
