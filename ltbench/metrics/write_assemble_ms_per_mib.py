"""Block writing: milliseconds of the ``write.assemble`` spans (each block's
chunks read from the source into one buffer, on the assembler threads)
per MiB they assembled."""

from ltbench import program_spans


def read(ctx):
    return program_spans.ms_per_mib(ctx, "write.assemble",
                                    of="write.assemble")
