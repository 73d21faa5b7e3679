"""Patch apply: milliseconds of the ``change.decode`` spans (host LZ4
decode of each fetched block) per MiB they decoded, summed over the
decode threads."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "change.decode", of="change.decode")
