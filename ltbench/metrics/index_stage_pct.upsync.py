"""Share (%) of the window's indexing wall (the build) spent copying parts
into the pinned batch (page faults of mapped files included) and
queueing its upload: the summed ``index.stage`` spans on the ``index``
span's thread over the summed ``index`` spans."""

from ltbench import program_spans


def read(ctx):
    return program_spans.index_pct(ctx, "index.stage")
