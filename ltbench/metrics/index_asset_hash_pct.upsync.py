"""Share (%) of the window's indexing wall (the build) spent hashing each
asset's path and chunk-hash bytes on the host: the summed
``index.asset_hash`` spans on the ``index`` span's thread over the
summed ``index`` spans."""

from ltbench import program_spans


def read(ctx):
    return program_spans.index_pct(ctx, "index.asset_hash")
