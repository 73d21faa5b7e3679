"""Host: the interpreter-lock wait probe's ``host.gil_wait`` spans (time
in which a runnable Python thread could not run: another thread held the
interpreter lock, or no core was free) inside the ``upsync`` spans, as a
share (%) of their summed wall."""

from ltbench import span_shares


def read(ctx):
    return span_shares.inside_pct(ctx, "host.gil_wait", "upsync")
