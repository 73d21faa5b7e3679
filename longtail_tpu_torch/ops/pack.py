"""Chunk bytes into aligned word rows: the wrapper of ``csrc/pack.cu``.

The counterpart of ``longtail_tpu/parallel/pipeline.py`` ``_pack_callable``.
``pack`` copies chunks, given by start and size in a flat byte batch,
into ``(rows, padded/4)`` little-endian int32 rows, zero past each
chunk's size: the rows of the JAX package's hash kernels and of the
port's row interfaces (``hash_chunks_words_device``), and the rows the
plain batch hashes (``ops.blake3.hash_chunks_batch``,
``ops.blake2.hash_chunks_batch``) run on.  No upsync path of the port
runs it: both hash kernels read the resident batch.  For a CPU tensor it
computes ``pack_plain``; for a CUDA tensor it launches the kernel or
raises.  ``pow2_cap``, ``class_floor`` and ``pow2_padded`` are the JAX
pipeline's power-of-two size classes of those rows.
"""

from __future__ import annotations

import numpy as np
import torch

from longtail_tpu_torch import _kernels

SOURCE = "longtail_tpu_torch/csrc/pack.cu"
REPLACES = "longtail_tpu/parallel/pipeline.py:166"

_LEAF = 1024


def pow2_cap(padded_chunk: int) -> int:
    """Largest size class: next power-of-two multiple of 1 KiB >=
    padded_chunk (the BLAKE3 row hash needs a power-of-two leaf count)."""
    leaves = -(-padded_chunk // _LEAF)
    p = 1
    while p < leaves:
        p *= 2
    return p * _LEAF


def class_floor(cfg) -> int:
    """Smallest size class of a ChunkerConfig: the power-of-two >= 2 *
    min_size (capped); smaller chunks pad up into it."""
    f = _LEAF
    target = min(2 * cfg.min_size, pow2_cap(cfg.padded_chunk))
    while f < target:
        f *= 2
    return f


def pow2_padded(sizes: np.ndarray, cap: int, floor: int = _LEAF
                ) -> np.ndarray:
    """Next power-of-two multiple of 1 KiB >= size, clamped to
    [floor, cap]."""
    leaves = np.maximum(-(-sizes // _LEAF), 1)
    pow2 = np.uint64(1) << np.uint64(
        np.ceil(np.log2(leaves)).astype(np.int64))
    return np.clip(pow2.astype(np.int64) * _LEAF, floor, cap)


def pack_plain(batch: torch.Tensor, starts: torch.Tensor,
               sizes: torch.Tensor, padded: int) -> torch.Tensor:
    """Plain pack: row r = bytes [starts[r], starts[r] + sizes[r]) of the
    batch, zero past sizes[r], as (rows, padded/4) little-endian int32."""
    off = torch.arange(padded, device=batch.device, dtype=torch.int64)
    idx = (starts.to(torch.int64)[:, None] + off[None, :]).clamp_(
        max=max(batch.numel() - 1, 0))
    valid = off[None, :] < sizes.to(torch.int64)[:, None]
    rows = torch.where(valid, batch[idx], torch.zeros((), dtype=torch.uint8,
                                                      device=batch.device))
    return rows.contiguous().view(torch.int32)


def hash_batch_by_class(batch: torch.Tensor, starts: torch.Tensor,
                        sizes: torch.Tensor, units: np.ndarray,
                        unit_bytes: int, hash_rows):
    """Plain hash of chunks of a flat batch: (batch uint8, starts, sizes
    (n,) int32) -> (lo, hi), each (n,) int32, in chunk order.  Chunks are
    grouped by the power of two >= their count of units (units (n,), the
    count per chunk), each group is gathered by pack_plain into
    zero-padded rows of class x unit_bytes, and hash_rows(words, sizes)
    -> (lo, hi) hashes the rows."""
    n = starts.numel()
    units = torch.from_numpy(np.asarray(units, np.int64))
    cls = torch.ones_like(units)
    while bool((cls < units).any()):
        cls = torch.where(cls < units, 2 * cls, cls)
    out = torch.zeros((2, n), dtype=torch.int32, device=batch.device)
    for c in torch.unique(cls).tolist():
        idx = torch.nonzero(cls == c).flatten().to(batch.device)
        sz = sizes[idx]
        lo, hi = hash_rows(
            pack_plain(batch, starts[idx], sz, c * unit_bytes), sz)
        out[0, idx], out[1, idx] = lo, hi
    return out[0], out[1]


def pack(batch: torch.Tensor, starts: torch.Tensor, sizes: torch.Tensor,
         padded: int) -> torch.Tensor:
    """Pack kernel wrapper; same contract as pack_plain."""
    if padded % _LEAF:
        raise ValueError(f"padded {padded} is not a multiple of {_LEAF}")
    if batch.device.type == "cpu":
        return pack_plain(batch, starts, sizes, padded)
    rows = starts.numel()
    _kernels.require("batch", batch, torch.uint8)
    _kernels.require("starts", starts, torch.int32, (rows,), batch.device)
    _kernels.require("sizes", sizes, torch.int32, (rows,), batch.device)
    if batch.dim() != 1 or batch.numel() % 4 or batch.data_ptr() % 4:
        raise ValueError("batch: a 1-D, word-aligned byte tensor is needed")
    out = torch.empty((rows, padded // 4), dtype=torch.int32,
                      device=batch.device)
    if rows:
        with torch.cuda.device(batch.device):
            rc = _kernels.load().lt_pack(
                batch.data_ptr(), batch.numel() // 4, starts.data_ptr(),
                sizes.data_ptr(), out.data_ptr(), rows, padded // 4,
                _kernels.stream_of(batch))
        _kernels.check(rc, "lt_pack")
        _kernels.count_launch(pack)
    return out


pack.LAUNCHES = 0
