"""BLAKE3-64 chunk hashing on the card: the wrapper of ``csrc/blake3.cu``.

The counterpart of ``longtail_tpu/ops/blake3_kernel.py``
(``hash_chunks_words_device``).  For a CPU tensor the wrapper computes
the plain version, ``ops.blake3.hash_chunks_words``; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from longtail_tpu_torch import _kernels
from longtail_tpu_torch.ops.blake3 import hash_chunks_words, leaves_per_row

SOURCE = "longtail_tpu_torch/csrc/blake3.cu"
REPLACES = "longtail_tpu/ops/blake3_kernel.py:216"


def hash_chunks_words_device(words: torch.Tensor, lengths: torch.Tensor):
    """BLAKE3-64 of each row: words (rows, padded/4) int32, zero past each
    row's length, lengths (rows,) int32 -> (lo, hi), each (rows,) int32."""
    if words.device.type == "cpu":
        return hash_chunks_words(words, lengths)
    rows, row_words = words.shape
    if leaves_per_row(row_words) > 1024:
        raise ValueError(f"rows of {row_words * 4} bytes exceed the kernel's "
                         "1024 leaves")
    _kernels.require("words", words, torch.int32)
    _kernels.require("lengths", lengths, torch.int32, (rows,), words.device)
    out = torch.empty((2, rows), dtype=torch.int32, device=words.device)
    if rows:
        with torch.cuda.device(words.device):
            rc = _kernels.load().lt_blake3(
                words.data_ptr(), lengths.data_ptr(), out.data_ptr(), rows,
                row_words, _kernels.stream_of(words))
        _kernels.check(rc, "lt_blake3")
        _kernels.count_launch(hash_chunks_words_device)
    return out[0], out[1]


hash_chunks_words_device.LAUNCHES = 0
