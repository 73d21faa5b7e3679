"""Block codec: milliseconds of the ``codec.anchors_decode`` spans (the
anchor rows decoded on the host into match hints) per MiB of raw block
bytes put (``write.put``), summed over the writer threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "codec.anchors_decode")
