"""Block codec: milliseconds of the ``codec.assemble`` spans (the host's
LZ4 assembly over the card's anchors) per MiB of raw block bytes put,
summed over the writer threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "codec.assemble")
