"""BLAKE3: the host hasher and the plain PyTorch batched chunk hash.

The host half is the port's copy of ``longtail_tpu/ops/blake3.py``
without its jax branches: the constants, the scalar oracle (``blake3``,
``hash64``), ``hash_chunks`` (host rows in, u64 digests out) and the
native batch path (``hash64_ranges``).  The reference wraps upstream
BLAKE3 and takes the first 8 bytes of the digest as the 64-bit
chunk/content hash (lib/blake3/longtail_blake3.c:81-102).

``hash_chunks_words`` is the JAX package's batched lane form in torch
lane math: every 1 KiB leaf of every row is a lane, the 16 block
compressions run as masked lane updates and the tree merges adjacent
pairs level by level (an odd tail carries up).  torch has no unsigned
32-bit arithmetic, so words ride as int64 masked to 32 bits.  Its
contract: words ``(rows, padded/4)`` int32, little-endian and zero past
each row's length, with a power-of-two leaf count per row; lengths
``(rows,)``; returns ``(lo, hi)``, each ``(rows,)`` int32 holding the u32
digest words.  The host ``hash_chunks`` runs it on the CPU.

``hash_chunks_batch`` is the plain version of the CUDA kernel in
``blake3_kernel.py``: the digests of chunks given by start and size in a
flat byte batch, through ``ops.pack.hash_batch_by_class`` and
``hash_chunks_words`` per power-of-two class.  ``plan_blocks`` is the
kernel's host work plan.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from longtail_tpu_torch.ops.pack import hash_batch_by_class

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

# Message word permutation applied between rounds.
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_BYTES = 64
LEAF_BYTES = 1024  # BLAKE3 "chunk" (leaf) size; we say "leaf" to avoid
                   # clashing with longtail's CDC chunks.

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Scalar oracle (python ints) — used for small host-side inputs (path hashes,
# hash-of-hashes) and as the conformance oracle for the batched versions.
# ---------------------------------------------------------------------------

def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK32


def _g(v: list, a: int, b: int, c: int, d: int, x: int, y: int) -> None:
    v[a] = (v[a] + v[b] + x) & _MASK32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _MASK32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & _MASK32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _MASK32
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(h, m, t: int, b: int, flags: int) -> list:
    v = list(h[:8]) + list(IV[:4]) + [t & _MASK32, (t >> 32) & _MASK32, b, flags]
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
    return [(v[i] ^ v[i + 8]) & _MASK32 for i in range(8)] + \
           [(v[i + 8] ^ h[i]) & _MASK32 for i in range(8)]


def _block_words(block: bytes) -> tuple:
    return struct.unpack("<16I", block + b"\0" * (BLOCK_BYTES - len(block)))


def _leaf_output(data: bytes, counter: int, is_root: bool) -> list:
    h = list(IV)
    n_blocks = max(1, (len(data) + BLOCK_BYTES - 1) // BLOCK_BYTES)
    out = None
    for i in range(n_blocks):
        blk = data[i * BLOCK_BYTES:(i + 1) * BLOCK_BYTES]
        flags = (CHUNK_START if i == 0 else 0) | \
                (CHUNK_END if i == n_blocks - 1 else 0)
        if is_root and i == n_blocks - 1:
            flags |= ROOT
        out = _compress(h, _block_words(blk), counter, len(blk), flags)
        h = out[:8]
    return out


def _parent_output(left_cv, right_cv, is_root: bool) -> list:
    return _compress(list(IV), list(left_cv) + list(right_cv), 0, BLOCK_BYTES,
                     PARENT | (ROOT if is_root else 0))


def _subtree(data: bytes, counter: int, is_root: bool) -> list:
    n_leaves = max(1, (len(data) + LEAF_BYTES - 1) // LEAF_BYTES)
    if n_leaves == 1:
        return _leaf_output(data, counter, is_root)
    # left subtree takes the largest power of two of leaves < n_leaves
    p = 1
    while p * 2 < n_leaves:
        p *= 2
    left = _subtree(data[:p * LEAF_BYTES], counter, False)[:8]
    right = _subtree(data[p * LEAF_BYTES:], counter + p, False)[:8]
    return _parent_output(left, right, is_root)


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """Full BLAKE3 digest (default 32 bytes; extendable up to 64 here)."""
    out = _subtree(data, 0, True)
    return struct.pack("<16I", *out)[:out_len]


def hash64(data: bytes) -> int:
    """The longtail 64-bit hash: first 8 digest bytes as little-endian uint64
    (lib/blake3/longtail_blake3.c:100)."""
    out = _subtree(data, 0, True)
    return out[0] | (out[1] << 32)


_M = 0xFFFFFFFF
_LEAF_WORDS = LEAF_BYTES // 4
_BLOCKS_PER_LEAF = LEAF_BYTES // BLOCK_BYTES


def _compress_lanes(h, m, counter, block_len, flags):
    """First 8 output words of one compression over int64 lanes (``_g``
    is the scalar oracle's: the same expressions hold for tensors)."""
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
        cv = _compress_lanes(h, m, counter, blk_len, flags)
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
        cv = _compress_lanes(iv, left + right, 0, BLOCK_BYTES,
                       PARENT | torch.where(is_root, ROOT, 0))
        cvs = [torch.where(has_right, cv[i], left[i]) for i in range(8)]
        count = (count + 1) // 2
        width = half
    return to_int32(cvs[0][:, 0]), to_int32(cvs[1][:, 0])

# the batch kernel's geometry (csrc/blake3.cu): a block has BLOCK_LEAVES
# threads and takes the chunks whose first leaf falls in its range of
# BLOCK_LEAVES leaves; a chunk has at most MAX_LEAVES leaves
BLOCK_LEAVES = 128
MAX_LEAVES = 1024


def leaves_of(sizes: np.ndarray) -> np.ndarray:
    """Leaves of each chunk, max(1, ceil(size / 1 KiB)); raises past
    MAX_LEAVES."""
    leaves = np.maximum(-(-np.asarray(sizes, np.int64) // LEAF_BYTES), 1)
    if len(leaves) and leaves.max() > MAX_LEAVES:
        raise ValueError(f"a chunk of {int(leaves.max())} leaves exceeds "
                         f"the kernel's {MAX_LEAVES}")
    return leaves


def plan_blocks(leaves: np.ndarray) -> np.ndarray:
    """The kernel's work plan: (n_blocks + 1,) int32, the first chunk of
    each block, then the chunk count.  Block b takes the chunks (whole,
    in order) whose first leaf lies in [b, b + 1) * BLOCK_LEAVES, so it
    holds at most BLOCK_LEAVES chunks and BLOCK_LEAVES - 1 + MAX_LEAVES
    leaves; ranges where no chunk starts get no block.  Any upper bounds
    of the chunks' leaves give a valid plan."""
    leaves = np.asarray(leaves, np.int64)
    first_leaf = np.cumsum(leaves) - leaves
    blk = first_leaf // BLOCK_LEAVES
    firsts = np.flatnonzero(np.diff(blk, prepend=-1))
    return np.append(firsts, len(leaves)).astype(np.int32)


def hash_chunks_batch(batch: torch.Tensor, starts: torch.Tensor,
                      sizes: torch.Tensor):
    """Plain BLAKE3-64 of chunks of a flat batch: (batch uint8, starts,
    sizes (n,) int32) -> (lo, hi), each (n,) int32, in chunk order.
    Chunks are grouped by power-of-two leaf count and each group hashed
    as packed rows."""
    return hash_batch_by_class(batch, starts, sizes,
                               leaves_of(sizes.cpu().numpy()), LEAF_BYTES,
                               hash_chunks_words)


def hash_chunks(data_u8, lengths) -> np.ndarray:
    """Batched host hashing: (lanes, padded) uint8 rows, zero past each
    lane's length, padded a power-of-two count of 1 KiB leaves, and
    (lanes,) lengths -> (lanes,) uint64 digests, through
    ``hash_chunks_words`` on the CPU."""
    data_u8 = np.ascontiguousarray(data_u8, dtype=np.uint8)
    words = torch.from_numpy(data_u8.view("<i4"))
    lo, hi = hash_chunks_words(words, torch.from_numpy(
        np.asarray(lengths, dtype=np.int64)))
    lo = lo.numpy().view(np.uint32).astype(np.uint64)
    hi = hi.numpy().view(np.uint32).astype(np.uint64)
    return lo | (hi << np.uint64(32))


# ---------------------------------------------------------------------------
# native host fast path (native/blake3_hash.c): the from-spec
# C implementation, cross-checked against this module's KAT-verified oracle.
# ---------------------------------------------------------------------------

_native_lib = None


def _native():
    """Bind the native hasher once; False caches a failed probe."""
    global _native_lib
    if _native_lib is None:
        try:
            import ctypes

            from longtail_tpu_torch import native
            lib = native.load("blake3_hash", ["blake3_hash.c"])
            if lib is not None:
                lib.lt_blake3_hash64.restype = None
                lib.lt_blake3_hash64.argtypes = [
                    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
                lib.lt_blake3_hash64_batch.restype = None
                lib.lt_blake3_hash64_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_long, ctypes.c_void_p]
            _native_lib = lib if lib is not None else False
        except Exception:
            _native_lib = False
    return _native_lib or None


def hash64_ranges(base_u8: np.ndarray, offsets: np.ndarray,
                  sizes: np.ndarray) -> np.ndarray | None:
    """Hash chunks [offsets[i], offsets[i]+sizes[i]) of base_u8 natively;
    None when the native library is unavailable (caller falls back)."""
    lib = _native()
    if lib is None:
        return None
    base_u8 = np.ascontiguousarray(base_u8, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    out = np.empty(len(sizes), dtype=np.uint64)
    if len(sizes):
        lib.lt_blake3_hash64_batch(
            base_u8.ctypes.data, offsets.ctypes.data, sizes.ctypes.data,
            len(sizes), out.ctypes.data)
    return out
