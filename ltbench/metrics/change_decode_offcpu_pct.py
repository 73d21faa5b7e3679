"""Patch apply: share (%) of the ``change.decode`` spans' wall that their
threads spent off the CPU (wall less the thread's CPU time): the
interpreter lock, other locks."""

from ltbench import span_shares


def read(ctx):
    return span_shares.offcpu_pct(ctx, "change.decode")
