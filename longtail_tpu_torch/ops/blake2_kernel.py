"""BLAKE2s-64 chunk hashing on the card: the wrapper of ``csrc/blake2.cu``.

The counterpart of ``longtail_tpu/ops/blake2_kernel.py``.  One kernel
hashes chunks where they lie in a flat byte batch:

- ``hash_chunks_device(batch, starts, sizes, order)``: every chunk of a
  resident batch in one launch, taken in ``order`` (from
  ``ops.blake2.plan_order``; the pipeline's stage 3);
- ``hash_chunks_words_device(words, lengths)``: packed rows, the JAX
  package's entry of that name, as chunks starting at each row.

For a CPU tensor each wrapper computes the plain version
(``ops.blake2.hash_chunks_batch``, ``hash_chunks_words``); for a CUDA
tensor it launches the kernel or raises.  Every row is hashed,
zero-length rows included (the port's pipeline has no padding rows to
skip).
"""

from __future__ import annotations

import torch

from longtail_tpu_torch import _kernels
from longtail_tpu_torch.ops.blake2 import (
    BLOCK_BYTES,
    hash_chunks_batch,
    hash_chunks_words,
)

SOURCE = "longtail_tpu_torch/csrc/blake2.cu"
REPLACES = "longtail_tpu/ops/blake2_kernel.py:67"


def hash_chunks_device(batch: torch.Tensor, starts: torch.Tensor,
                       sizes: torch.Tensor, order: torch.Tensor):
    """BLAKE2s-64 of chunks [starts[i], starts[i] + sizes[i]) of the flat
    uint8 batch: starts, sizes (n,) int32, order (n,) int32 a permutation
    of the chunks (plan_order: the kernel's thread order) -> (lo, hi),
    each (n,) int32, in chunk order."""
    if batch.device.type == "cpu":
        return hash_chunks_batch(batch, starts, sizes)
    n = starts.numel()
    dev = batch.device
    _kernels.require("batch", batch, torch.uint8)
    _kernels.require("starts", starts, torch.int32, (n,), dev)
    _kernels.require("sizes", sizes, torch.int32, (n,), dev)
    _kernels.require("order", order, torch.int32, (n,), dev)
    if batch.dim() != 1 or batch.numel() % 16 or batch.data_ptr() % 16:
        raise ValueError("batch: a 1-D byte tensor of 16-byte aligned "
                         "16-byte words is needed")
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            rc = _kernels.load().lt_blake2(
                batch.data_ptr(), batch.numel(), starts.data_ptr(),
                sizes.data_ptr(), order.data_ptr(), out.data_ptr(), n,
                _kernels.stream_of(batch))
        _kernels.check(rc, "lt_blake2")
        _kernels.count_launch(hash_chunks_device)
    return out[0], out[1]


hash_chunks_device.LAUNCHES = 0


def hash_chunks_words_device(words: torch.Tensor, lengths: torch.Tensor):
    """BLAKE2s-64 of each row: words (rows, padded/4) int32, zero past
    each row's length, lengths (rows,) int32 -> (lo, hi), each (rows,)
    int32.  The batch kernel on the rows' bytes, row r a chunk at r *
    padded, in row order (no read of the lengths on the host)."""
    if words.device.type == "cpu":
        return hash_chunks_words(words, lengths)
    rows, row_words = words.shape
    if (row_words * 4) % BLOCK_BYTES or row_words == 0:
        raise ValueError(f"rows of {row_words * 4} bytes are not a positive "
                         f"multiple of {BLOCK_BYTES}")
    if rows * row_words * 4 >= 2**31:
        raise ValueError("rows: the kernel's starts are int32")
    _kernels.require("words", words, torch.int32)
    _kernels.require("lengths", lengths, torch.int32, (rows,), words.device)
    dev = words.device
    starts = torch.arange(0, rows * row_words * 4, row_words * 4,
                          dtype=torch.int32, device=dev)
    order = torch.arange(rows, dtype=torch.int32, device=dev)
    return hash_chunks_device(words.view(-1).view(torch.uint8), starts,
                              lengths, order)
