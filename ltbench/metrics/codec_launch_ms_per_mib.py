"""Block codec: milliseconds of the ``codec.launch`` spans (the LZ4 anchor
search's launches on the card, the copy of its counts to the host and
the event's record) per MiB of raw block bytes put (``write.put``),
summed over the writer threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "codec.launch")
