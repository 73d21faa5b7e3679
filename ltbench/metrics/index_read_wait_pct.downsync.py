"""Share (%) of the window's indexing wall (the re-index of the client
folder) spent the indexing thread blocked on the reader thread's queue
of file parts (its reads and page faults not yet done): the summed
``index.read_wait`` spans on the ``index`` span's thread over the summed
``index`` spans."""

from ltbench import program_spans


def read(ctx):
    return program_spans.index_pct(ctx, "index.read_wait")
