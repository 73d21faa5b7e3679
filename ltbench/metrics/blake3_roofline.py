"""BLAKE3's share of its roofline in one traced job: the least time of
hashing the chunks that went through the card (their 64-byte
compressions at BLAKE3_OPS each, every byte read once, 8 bytes written
per digest), over the device time of the kernels named below."""

from ltbench import roofline

KERNELS = ("blake3_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.lvi is None:
        return None
    seconds = ctx.trace.device_s(KERNELS)
    _, chunks = roofline.device_chunks(ctx.lvi)
    if not seconds or not len(chunks):
        return None
    least_ms, _ = roofline.bound(*roofline.blake3_work(chunks))
    return 100.0 * least_ms / (seconds * 1e3)
