"""BLAKE2s-64 constants and the plain PyTorch batched chunk hash.

The constants are the port's copy of ``longtail_tpu/ops/blake2.py``'s
(BLAKE2s at digest size 8, lib/blake2/longtail_blake2.c:43; the host
hasher, ``hash_registry.Blake2Hasher``, hashes with ``hashlib``).
``hash_chunks_words`` is ``longtail_tpu.ops.blake2.hash_chunks_words`` in
torch lane math: every row is a lane, and its
64-byte blocks compress one after another as masked lane updates.  torch
has no unsigned 32-bit arithmetic, so words ride as int64 masked to 32
bits.

``hash_chunks_words`` has the port's BLAKE3 row contract: words
``(rows, padded/4)`` int32, little-endian and zero past each row's
length, padded a multiple of 64; lengths ``(rows,)``; returns ``(lo,
hi)``, each ``(rows,)`` int32 holding the u32 digest words.  A
zero-length row hashes one zero final block (the empty-message digest).
``hash_chunks_batch`` is the plain version of the CUDA kernel in
``blake2_kernel.py``: chunks given by start and size in a flat byte
batch, gathered into zero-padded rows; ``plan_order`` is the kernel's
order of the chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from longtail_tpu_torch.ops.blake3 import to_int32
from longtail_tpu_torch.ops.pack import hash_batch_by_class

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

BLOCK_BYTES = 64
DIGEST_BYTES = 8

# param block word 0: digest_length | (key_length << 8) | (fanout << 16)
# | (depth << 24), fanout = depth = 1 (sequential mode)
PARAM0 = DIGEST_BYTES | (1 << 16) | (1 << 24)

_M = 0xFFFFFFFF


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & _M
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(h, m, t, final):
    """One BLAKE2s compression of every lane (int64 lanes); t the byte
    counter (< 2**32), final the lanes whose block is their last."""
    z = torch.zeros_like(h[0])
    v = list(h) + [z + IV[i] for i in range(4)] + [
        t ^ IV[4], z + IV[5], torch.where(final, IV[6] ^ _M, IV[6]),
        z + IV[7]]
    for s in SIGMA:
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def hash_chunks_words(words: torch.Tensor, lengths: torch.Tensor):
    """Plain BLAKE2s-64 of each row: (words, lengths) -> (lo, hi)."""
    rows, row_words = words.shape
    padded = row_words * 4
    if padded % BLOCK_BYTES or padded == 0:
        raise ValueError(f"rows of {padded} bytes are not a positive "
                         f"multiple of {BLOCK_BYTES}")
    w = words.to(torch.int64) & _M
    lengths = lengths.to(device=words.device, dtype=torch.int64)
    n_blocks = torch.clamp((lengths + BLOCK_BYTES - 1) // BLOCK_BYTES, min=1)
    h = [torch.full((rows,), IV[i], dtype=torch.int64, device=words.device)
         for i in range(8)]
    h[0] = h[0] ^ PARAM0
    for k in range(padded // BLOCK_BYTES):
        active = k < n_blocks
        if not bool(active.any()):
            break
        m = [w[:, 16 * k + j] for j in range(16)]
        t = torch.clamp(lengths, max=(k + 1) * BLOCK_BYTES)
        out = _compress(h, m, t, n_blocks == k + 1)
        h = [torch.where(active, out[i], h[i]) for i in range(8)]
    return to_int32(h[0]), to_int32(h[1])


def blocks_of(sizes: np.ndarray) -> np.ndarray:
    """Compressions of each chunk, max(1, ceil(size / 64))."""
    return np.maximum(-(-np.asarray(sizes, np.int64) // BLOCK_BYTES), 1)


def plan_order(sizes: np.ndarray) -> np.ndarray:
    """The batch kernel's order of the chunks: (n,) int32, a permutation
    by descending block count (stable), so that a warp's chains have
    nearly equal lengths and the longest start first."""
    return np.argsort(-blocks_of(sizes), kind="stable").astype(np.int32)


def hash_chunks_batch(batch: torch.Tensor, starts: torch.Tensor,
                      sizes: torch.Tensor):
    """Plain BLAKE2s-64 of chunks of a flat batch: (batch uint8, starts,
    sizes (n,) int32) -> (lo, hi), each (n,) int32, in chunk order.
    Chunks are grouped by power-of-two block count, and each group is
    gathered into zero-padded rows and hashed by hash_chunks_words."""
    return hash_batch_by_class(batch, starts, sizes,
                               blocks_of(sizes.cpu().numpy()), BLOCK_BYTES,
                               hash_chunks_words)
