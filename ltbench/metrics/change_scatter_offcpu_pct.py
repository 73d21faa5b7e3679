"""Patch apply: share (%) of the ``change.scatter`` spans' wall that their
threads spent off the CPU (wall less the thread's CPU time): the
interpreter lock, the storage's lock, I/O."""

from ltbench import span_shares


def read(ctx):
    return span_shares.offcpu_pct(ctx, "change.scatter")
