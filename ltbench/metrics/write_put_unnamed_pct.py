"""Block writing: share (%) of the ``write.put`` spans' wall that none of
their child spans (the codec's steps, ``codec.frame``, ``store.put``)
covers: what the spans leave unnamed in a put."""

from ltbench import span_shares


def read(ctx):
    return span_shares.unnamed_pct(ctx, "write.put", "store.put")
