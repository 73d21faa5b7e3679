"""Block writing: milliseconds of the ``store.put`` spans (the block store
serialises each compressed block, writes it under a temporary name,
renames it and updates its index) per MiB of raw block bytes put
(``write.put``), summed over the writer threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "store.put")
