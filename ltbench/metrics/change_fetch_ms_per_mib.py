"""Patch apply: milliseconds of the ``change.fetch`` spans (each needed
block read from the store) per MiB that ``change.decode`` decoded,
summed over the fetch threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "change.fetch", of="change.decode")
