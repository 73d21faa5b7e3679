"""Stage 1's share of its roofline in one traced job: the least time of
the scan and walk's work (every byte through the card read once, 4 bytes
written per chunk boundary, SCAN_OPS operations per byte), over the
device time of the kernels named below."""

from ltbench import roofline

KERNELS = ("scan_kernel", "walk_kernel")


def read(ctx):
    if ctx.trace is None or ctx.lvi is None:
        return None
    seconds = ctx.trace.device_s(KERNELS)
    sizes, chunks = roofline.device_chunks(ctx.lvi)
    if not seconds or not len(chunks):
        return None
    least_ms, _ = roofline.bound(*roofline.stage1_work(sizes, chunks))
    return 100.0 * least_ms / (seconds * 1e3)
