"""Block codec cost: the wall of every put_stored_block call of the
window (compression on the card and the host, then the store's write),
summed over the writer threads, per MiB of raw block bytes."""


def read(ctx):
    hits = [s for s in ctx.spans if s[0] == "put_stored_block"]
    mib = sum(s[3] for s in hits) / (1 << 20)
    return sum(s[2] - s[1] for s in hits) * 1e3 / mib if mib else None
