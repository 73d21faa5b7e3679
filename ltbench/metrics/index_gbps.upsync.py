"""Indexing rate: bytes indexed over the summed wall of the window's
create_version_index spans (reads, staging, the data plane, per-asset
hashing)."""


def read(ctx):
    hits = [s for s in ctx.spans if s[0] == "create_version_index"]
    seconds = sum(s[2] - s[1] for s in hits)
    return sum(s[3] for s in hits) / seconds / 1e9 if seconds else None
