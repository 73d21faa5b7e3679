"""Device-assisted zstd: the fast-tier anchor scan on a torch device, the
native sequence walk on the host, then the entropy stage — port of
``compress_block`` of ``longtail_tpu/ops/zstd_device.py``.

- **Match finding on the device**: ``device_match.fast_block_anchors``
  with the window opened to the whole block (zstd offsets are not
  LZ4-limited), the long-distance-matcher role.
- **Sequence assembly on the host**: the native walk (``zstd_seq.c``
  through ``_host.sequences_from_anchors``) memcmp-validates and
  byte-extends the anchors into ZSTD_Sequence rows.
- **Entropy stage**: ``entropy="device"`` (default) builds the frame from
  spec with the literals' Huffman pack on the device
  (``ops/device_entropy.frame_from_sequences``); ``entropy="libzstd"``
  hands the sequences to libzstd's ``ZSTD_compressSequences``.

Either way the output is one standard zstd frame.
"""

from __future__ import annotations

import numpy as np
import torch

from longtail_tpu_torch import _host
from longtail_tpu_torch.ops.device_entropy import frame_from_sequences
from longtail_tpu_torch.parallel.device_match import (
    _GPOS_BITS,
    fast_block_anchors,
)

MIN_BLOCK = 1 << 16               # smaller blocks take host zstd
MAX_BLOCK = 4 << _GPOS_BITS       # anchor word positions carry 22 bits


def compress_block(src: bytes, level: int = 3, entropy: str = "device", *,
                   device) -> bytes:
    """One zstd frame for ``src`` with the match search on ``device``.

    The JAX package's size policy holds: blocks under 64 KiB or over
    16 MiB (where anchor positions would wrap) take host zstd, and so
    does the libzstd tier where libzstd lacks ZSTD_compressSequences or
    rejects the sequences."""
    n = len(src)
    if n < MIN_BLOCK or n > MAX_BLOCK or (
            entropy == "libzstd" and _host._zstd_api() is None):
        return _host.zstd.compress(src, level)
    # pow2 size classes, as the JAX package pads
    npad = MIN_BLOCK
    while npad < n:
        npad *= 2
    buf = np.zeros(npad, np.uint8)
    buf[:n] = np.frombuffer(src, np.uint8)
    words = torch.from_numpy(buf.view(np.int32)).to(device)
    (apos, aref), = fast_block_anchors(
        words, npad // 4, max_offset_words=npad // 4,
        suppress_sampled_chains=False)
    keep = apos < n
    seqs = _host.sequences_from_anchors(src, apos[keep], aref[keep])
    if entropy == "device":
        return frame_from_sequences(src, seqs, device)
    out = _host.compress_sequences(src, seqs, level)
    if out is None:
        return _host.zstd.compress(src, level)
    return out
