"""Block writing: share (%) of an assembled block's time from the end of
its assembly to the end of its put that it waits for one of the put
workers (``write.put_wait`` over ``write.put_wait`` + ``write.put``)."""

from ltbench import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    if spans is None:
        return None
    wait = program_spans.wall(spans, "write.put_wait")
    put = program_spans.wall(spans, "write.put")
    if not put:
        return None
    return 100.0 * wait / (wait + put)
