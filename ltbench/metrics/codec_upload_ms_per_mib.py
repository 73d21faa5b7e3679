"""Block codec: milliseconds of the ``codec.upload`` spans (each LZ4 block
padded and copied to the card from pageable memory) per MiB of raw block
bytes put (``write.put``), summed over the writer threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "codec.upload")
