"""Share (%) of the assets of the window's indexing (the build) whose
path and content hashes the native batch gave: the summed ``n`` of the
``index.asset_hash.batch`` spans over the summed ``n`` of the
``index.asset_hash`` spans.  None where the program records no batch
span (a program without one, or with no native hasher)."""

from ltbench import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    if spans is None:
        return None
    batched = [s.n for s in spans if s.name == "index.asset_hash.batch"]
    assets = sum(s.n for s in spans if s.name == "index.asset_hash")
    if not batched or not assets:
        return None
    return 100.0 * sum(batched) / assets
