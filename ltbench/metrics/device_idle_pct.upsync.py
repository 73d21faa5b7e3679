"""The card's idle share of one traced job: 100 less the share of the
job's wall that the union of kernel, copy and memset intervals covers."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
