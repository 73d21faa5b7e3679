"""Patch apply: milliseconds of the ``change.scatter`` spans (each decoded
block's chunks written into the client's files) per MiB that
``change.decode`` decoded, summed over the scatter threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "change.scatter",
                                    of="change.decode")
