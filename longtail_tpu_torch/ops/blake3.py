"""BLAKE3 constants and the plain PyTorch batched chunk hash.

The constants are the host module's own values (``longtail_tpu/ops/
blake3.py``), so the two packages share one source of truth.
``hash_chunks_words`` is ``longtail_tpu.ops.blake3.hash_chunks_words`` in
torch lane math: every 1 KiB leaf of every row is a lane, the 16 block
compressions run as masked lane updates and the tree merges adjacent
pairs level by level (an odd tail carries up).  torch has no unsigned
32-bit arithmetic, so words ride as int64 masked to 32 bits.

It is the plain version of the CUDA kernel in ``blake3_kernel.py`` and has
its contract: words ``(rows, padded/4)`` int32, little-endian and zero
past each row's length, with a power-of-two leaf count per row; lengths
``(rows,)``; returns ``(lo, hi)``, each ``(rows,)`` int32 holding the u32
digest words.
"""

from __future__ import annotations

import torch

from longtail_tpu_torch import _host

_b3 = _host.host_blake3
IV = _b3.IV
PERM = _b3.PERM
CHUNK_START = _b3.CHUNK_START
CHUNK_END = _b3.CHUNK_END
PARENT = _b3.PARENT
ROOT = _b3.ROOT
BLOCK_BYTES = _b3.BLOCK_BYTES
LEAF_BYTES = _b3.LEAF_BYTES

_M = 0xFFFFFFFF
_LEAF_WORDS = LEAF_BYTES // 4
_BLOCKS_PER_LEAF = LEAF_BYTES // BLOCK_BYTES


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


def _compress(h, m, counter, block_len, flags):
    """First 8 output words of one compression over int64 lanes."""
    z = torch.zeros_like(h[0])
    v = list(h) + [z + IV[i] for i in range(4)] + \
        [z + counter, z, z + block_len, z + flags]
    m = list(m)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in PERM]
    return [v[i] ^ v[i + 8] for i in range(8)]


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def leaves_per_row(row_words: int) -> int:
    """Leaf count of a (rows, row_words) batch; raises unless it is a
    positive power of two (the tree kernel's requirement)."""
    leaves = row_words // _LEAF_WORDS
    if row_words % _LEAF_WORDS or leaves < 1 or leaves & (leaves - 1):
        raise ValueError(f"rows of {row_words} words are not a power-of-two "
                         f"count of {LEAF_BYTES}-byte leaves")
    return leaves


def hash_chunks_words(words: torch.Tensor, lengths: torch.Tensor):
    """Plain BLAKE3-64 of each row: (words, lengths) -> (lo, hi)."""
    rows, row_words = words.shape
    ml = leaves_per_row(row_words)
    n = rows * ml
    w = (words.to(torch.int64) & _M).reshape(n, _LEAF_WORDS)
    lengths = lengths.to(device=words.device, dtype=torch.int64)
    n_leaves = torch.clamp((lengths + LEAF_BYTES - 1) // LEAF_BYTES, min=1)
    leaf = torch.arange(ml, device=words.device, dtype=torch.int64)
    leaf_len = torch.clamp(lengths[:, None] - leaf[None, :] * LEAF_BYTES,
                           0, LEAF_BYTES).reshape(n)
    counter = (torch.zeros((rows, 1), dtype=torch.int64,
                           device=words.device) + leaf).reshape(n)
    root = (n_leaves == 1).repeat_interleave(ml)
    n_blocks = torch.clamp((leaf_len + BLOCK_BYTES - 1) // BLOCK_BYTES, min=1)

    # leaf stage; for a single-leaf row the ROOT-flagged last block leaves
    # the digest in h[0], h[1] of leaf 0, which the merge never touches
    h = [torch.full((n,), IV[i], dtype=torch.int64, device=words.device)
         for i in range(8)]
    for k in range(_BLOCKS_PER_LEAF):
        m = [w[:, 16 * k + j] for j in range(16)]
        blk_len = torch.clamp(leaf_len - k * BLOCK_BYTES, 0, BLOCK_BYTES)
        last = n_blocks == k + 1
        flags = (CHUNK_START if k == 0 else 0) \
            | torch.where(last, CHUNK_END, 0) \
            | torch.where(last & root, ROOT, 0)
        cv = _compress(h, m, counter, blk_len, flags)
        active = n_blocks > k
        h = [torch.where(active, cv[i], h[i]) for i in range(8)]

    # tree merge: adjacent pairs, an odd tail carries up
    cvs = [x.reshape(rows, ml) for x in h]
    count = n_leaves
    width = ml
    while width > 1:
        half = width // 2
        left = [c[:, 0::2] for c in cvs]
        right = [c[:, 1::2] for c in cvs]
        j = torch.arange(half, device=words.device, dtype=torch.int64)[None]
        has_right = 2 * j + 1 < count[:, None]
        is_root = (count[:, None] == 2) & (j == 0)
        iv = [torch.full_like(left[0], IV[i]) for i in range(8)]
        cv = _compress(iv, left + right, 0, BLOCK_BYTES,
                       PARENT | torch.where(is_root, ROOT, 0))
        cvs = [torch.where(has_right, cv[i], left[i]) for i in range(8)]
        count = (count + 1) // 2
        width = half
    return to_int32(cvs[0][:, 0]), to_int32(cvs[1][:, 0])
