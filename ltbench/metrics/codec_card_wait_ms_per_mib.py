"""Block codec: milliseconds of the ``codec.card_wait`` spans (a writer
waiting for its anchors' counts and rows on the card's default stream,
which all writers share) per MiB of raw block bytes put. None on the
CPU, which has no card to wait on."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "codec.card_wait", card=True)
