"""Share (%) of the window's indexing wall (the re-index of the client
folder) spent waiting, after the device stream ends, for the host path's
small files: the summed ``index.small_wait`` spans on the ``index``
span's thread over the summed ``index`` spans."""

from ltbench import program_spans


def read(ctx):
    return program_spans.index_pct(ctx, "index.small_wait")
