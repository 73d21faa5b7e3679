"""Share (%) of the window's indexing wall (the re-index of the client
folder) spent planning the hash on the host: walk output unpacked,
ambiguous lanes repaired, chunk starts, BLAKE3 plan, upload, launch: the
summed ``index.plan`` spans on the ``index`` span's thread over the
summed ``index`` spans."""

from ltbench import program_spans


def read(ctx):
    return program_spans.index_pct(ctx, "index.plan")
