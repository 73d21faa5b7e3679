"""Device LZ4 block codec: the batched anchor scan on a torch device plus
the host's LZ4 assembly — port of ``longtail_tpu/parallel/device_lz4.py``.

The match search (``parallel/device_match.anchor_rows``, three batched
row sorts) runs where the words lie; the byte-level LZ4 stream is
assembled on the host by the native walk of ``ops/lz4.py``
(``assemble_anchors``), which memcmp-validates and byte-extends every
anchor, so the device output is a hint, never a correctness dependency.
Outputs are standard LZ4 blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from longtail_tpu_torch.ops import lz4
from longtail_tpu_torch.parallel.device_match import (
    _POS_BITS,
    _POS_MASK,
    MAX_ANCHORS,
    ROW_WORDS,
    anchor_rows,
)
from longtail_tpu_torch.utils.monitor import span

ROW_BYTES = ROW_WORDS * 4


def block_anchors(src: bytes, device):
    """One-shot device anchor scan of a host buffer: position-sorted
    (pos, ref) byte-offset arrays (hints for any LZ assembler)."""
    n = len(src)
    with span("codec.upload"):
        # whole rows: rows are sorted independently, so the zero padding
        # only adds anchors at or past n, which are dropped below
        buf = np.zeros(max(1, -(-n // ROW_BYTES)) * ROW_BYTES, np.uint8)
        buf[:n] = np.frombuffer(src, np.uint8)
        words = torch.from_numpy(buf.view(np.int32)).to(device)
    with span("codec.launch", n):
        packed, counts = anchor_rows(words)
        ev = None
        if counts.device.type == "cuda":
            host = torch.empty(counts.shape, dtype=counts.dtype,
                               pin_memory=True)
            counts = host.copy_(counts, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(packed.device))
    with span("codec.card_wait"):
        if ev is not None:
            ev.synchronize()
        counts = counts.numpy()
        # only the columns up to the power of two >= the largest count
        # (at least 8, at most MAX_ANCHORS) come back
        k = 8
        while k < counts.max():
            k *= 2
        k = min(k, MAX_ANCHORS)
        rows = packed[:, :k].cpu().numpy().astype(np.uint32)
    with span("codec.anchors_decode") as sp:
        held = np.arange(k)[None, :] < counts[:, None]
        vals = rows[held]                 # row-major: position-sorted
        base = np.nonzero(held)[0].astype(np.int64) * ROW_BYTES
        pos = base + ((vals >> _POS_BITS) & _POS_MASK).astype(np.int64) * 4
        ref = base + (vals & _POS_MASK).astype(np.int64) * 4
        keep = pos < n
        pos, ref = pos[keep], ref[keep]
        sp.n = len(pos)
    return pos, ref


def compress_block(src: bytes, device) -> bytes:
    """Device anchor scan + host byte assembly; standard LZ4 block format.
    Blocks under one row (64 KiB) take the host compressor, as in the
    JAX package."""
    if len(src) < ROW_BYTES:
        return lz4.compress(src)
    pos, ref = block_anchors(src, device)
    with span("codec.assemble"):
        return lz4.assemble_anchors(src, pos, ref)
