"""Share (%) of the window's indexing wall (the re-index of the client
folder) spent waiting on the card for the walk output and the digests:
the summed ``index.card_wait`` spans on the ``index`` span's thread over
the summed ``index`` spans. None on the CPU, which has no card to wait
on."""

from ltbench import program_spans


def read(ctx):
    return program_spans.index_pct(ctx, "index.card_wait", card=True)
