"""BLAKE2s-64 chunk hashing on the card: the wrapper of ``csrc/blake2.cu``.

The counterpart of ``longtail_tpu/ops/blake2_kernel.py``
(``hash_chunks_words_device``).  For a CPU tensor the wrapper computes
the plain version, ``ops.blake2.hash_chunks_words``; for a CUDA tensor
it launches the kernel or raises.  Rows take the port's row-major
``(rows, padded/4)`` layout, not the TPU kernel's transposed one, and
every row is hashed, zero-length rows included (the port's pipeline has
no padding rows to skip).
"""

from __future__ import annotations

import torch

from longtail_tpu_torch import _kernels
from longtail_tpu_torch.ops.blake2 import BLOCK_BYTES, hash_chunks_words

SOURCE = "longtail_tpu_torch/csrc/blake2.cu"
REPLACES = "longtail_tpu/ops/blake2_kernel.py:67"


def hash_chunks_words_device(words: torch.Tensor, lengths: torch.Tensor):
    """BLAKE2s-64 of each row: words (rows, padded/4) int32, zero past
    each row's length, lengths (rows,) int32 -> (lo, hi), each (rows,)
    int32."""
    if words.device.type == "cpu":
        return hash_chunks_words(words, lengths)
    rows, row_words = words.shape
    if (row_words * 4) % BLOCK_BYTES or row_words == 0:
        raise ValueError(f"rows of {row_words * 4} bytes are not a positive "
                         f"multiple of {BLOCK_BYTES}")
    _kernels.require("words", words, torch.int32)
    _kernels.require("lengths", lengths, torch.int32, (rows,), words.device)
    if words.data_ptr() % 16:
        raise ValueError("words: the kernel reads 16-byte aligned rows")
    out = torch.empty((2, rows), dtype=torch.int32, device=words.device)
    if rows:
        with torch.cuda.device(words.device):
            rc = _kernels.load().lt_blake2(
                words.data_ptr(), lengths.data_ptr(), out.data_ptr(), rows,
                row_words, _kernels.stream_of(words))
        _kernels.check(rc, "lt_blake2")
        _kernels.count_launch(hash_chunks_words_device)
    return out[0], out[1]


hash_chunks_words_device.LAUNCHES = 0
