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
    ROW_WORDS,
    collect_anchors,
    decode_anchors,
    submit_anchors,
)
from longtail_tpu_torch.utils.monitor import span

ROW_BYTES = ROW_WORDS * 4


def block_anchors(src: bytes, device):
    """One-shot device anchor scan of a host buffer: position-sorted
    (pos, ref) byte-offset arrays (hints for any LZ assembler)."""
    n = len(src)
    with span("codec.upload"):
        # pow2 row counts, as the JAX package pads (its compiled-program
        # classes); the zero padding only adds anchors at or past n
        npad = ROW_BYTES
        while npad < n:
            npad *= 2
        buf = np.zeros(npad, np.uint8)
        buf[:n] = np.frombuffer(src, np.uint8)
        words = torch.from_numpy(buf.view(np.int32)).to(device)
    with span("codec.launch", n):
        handle = submit_anchors(words)
    rows, counts = collect_anchors(handle)
    with span("codec.anchors_decode") as sp:
        pos, ref = decode_anchors(rows, counts, 0, rows.shape[0])
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
