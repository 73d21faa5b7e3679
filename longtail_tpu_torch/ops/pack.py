"""Chunk bytes into aligned word rows: the wrapper of ``csrc/pack.cu``.

The counterpart of ``longtail_tpu/parallel/pipeline.py`` ``_pack_callable``.
``pack`` copies chunks, given by start and size in a flat byte batch,
into ``(rows, padded/4)`` little-endian int32 rows, zero past each
chunk's size: the BLAKE2 path's input, and the rows the plain BLAKE3
batch hash (``ops.blake3.hash_chunks_batch``) runs on.  For a CPU tensor
it computes ``pack_plain``; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from longtail_tpu_torch import _kernels

SOURCE = "longtail_tpu_torch/csrc/pack.cu"
REPLACES = "longtail_tpu/parallel/pipeline.py:166"

_LEAF = 1024


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
