"""BLAKE3, as longtail's 64-bit hash, in plain PyTorch over many messages.

Written from the BLAKE3 specification (https://github.com/BLAKE3-team/
BLAKE3-specs, section 2): 1024-byte chunks ("leaves" here, since longtail
calls its content pieces chunks) of 64-byte blocks compressed in turn,
and a binary tree of parent nodes whose left subtree holds the largest
power of two of leaves.  Pairing the nodes of each level from the left,
and carrying an odd last node up unchanged, builds exactly that tree.
longtail's hash is the first 8 bytes of the digest, little-endian
(lib/blake3/longtail_blake3.c).

All messages are hashed together: every leaf of every message compresses
its k-th block in one vectorised step, and every level of every tree in
another.  Words are int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
LEAF = 1024
BLOCK = 64
M32 = 0xFFFFFFFF
# leaves compressed per vectorised step
LEAVES_PER_STEP = 1 << 16


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(s, a, b, c, d, mx, my):
    s[a] = (s[a] + s[b] + mx) & M32
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & M32
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & M32
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & M32
    s[b] = _rotr(s[b] ^ s[c], 7)


def compress(cv, m, counter, block_len, flags):
    """The first 8 output words of the compression function: the next
    chaining value, and the digest's first words at a root.  cv: 8
    tensors (n,); m: 16 tensors (n,); counter, block_len, flags: (n,)."""
    like = m[0]
    s = list(cv) + [torch.full_like(like, IV[i]) for i in range(4)] + [
        counter & M32, (counter >> 32) & M32, block_len, flags]
    m = list(m)
    for r in range(7):
        _g(s, 0, 4, 8, 12, m[0], m[1])
        _g(s, 1, 5, 9, 13, m[2], m[3])
        _g(s, 2, 6, 10, 14, m[4], m[5])
        _g(s, 3, 7, 11, 15, m[6], m[7])
        _g(s, 0, 5, 10, 15, m[8], m[9])
        _g(s, 1, 6, 11, 12, m[10], m[11])
        _g(s, 2, 7, 8, 13, m[12], m[13])
        _g(s, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in PERM]
    return [s[i] ^ s[i + 8] for i in range(8)]


def _leaf_cvs(data: torch.Tensor, leaf_start, leaf_len, counter, single):
    """Chaining values (or, for one-leaf messages, root outputs) of the
    given leaves: (n, 8) int64."""
    n = len(leaf_start)
    dev = data.device
    rows = torch.as_strided(data, (len(data) - LEAF + 1, LEAF), (1, 1))
    out = torch.empty((n, 8), dtype=torch.int64, device=dev)
    for lo in range(0, n, LEAVES_PER_STEP):
        hi = min(n, lo + LEAVES_PER_STEP)
        ls, ll = leaf_start[lo:hi], leaf_len[lo:hi]
        blk = rows[ls].clone()
        blk[torch.arange(LEAF, device=dev)[None, :] >= ll[:, None]] = 0
        words = blk.view(torch.int32).to(torch.int64) & M32      # (k, 256)
        nb = torch.clamp((ll + BLOCK - 1) // BLOCK, min=1)
        cv = [torch.full((hi - lo,), IV[i], dtype=torch.int64, device=dev)
              for i in range(8)]
        ctr = counter[lo:hi]
        root = single[lo:hi]
        for k in range(int(nb.max())):
            live = nb > k
            last = nb == k + 1
            flags = (torch.where(last, CHUNK_END, 0)
                     | torch.where(last & root, ROOT, 0))
            if k == 0:
                flags = flags | CHUNK_START
            blen = torch.where(last, ll - k * BLOCK, BLOCK)
            m = [words[:, 16 * k + j] for j in range(16)]
            new = compress(cv, m, ctr, blen, flags)
            cv = [torch.where(live, a, b) for a, b in zip(new, cv)]
        out[lo:hi] = torch.stack(cv, 1)
    return out


def hash64(data: torch.Tensor, starts, lens) -> np.ndarray:
    """longtail's BLAKE3 64-bit hash of each message data[s:s + n]: uint64
    numpy (n_messages,).  data: a 1-D uint8 tensor on the device that
    computes; starts, lens: int64 arrays."""
    dev = data.device
    starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    lens = torch.as_tensor(np.asarray(lens, np.int64), device=dev)
    n_msg = len(starts)
    if n_msg == 0:
        return np.zeros(0, np.uint64)
    data = torch.cat([data.reshape(-1), torch.zeros(
        LEAF, dtype=torch.uint8, device=dev)])
    n_leaves = torch.clamp((lens + LEAF - 1) // LEAF, min=1)
    msg = torch.repeat_interleave(torch.arange(n_msg, device=dev), n_leaves)
    first = torch.cumsum(n_leaves, 0) - n_leaves
    idx = torch.arange(len(msg), device=dev) - first[msg]
    leaf_start = starts[msg] + idx * LEAF
    leaf_len = torch.clamp(lens[msg] - idx * LEAF, min=0, max=LEAF)
    cvs = _leaf_cvs(data, leaf_start, leaf_len, idx, n_leaves[msg] == 1)
    # the tree, one level at a time: pairs from the left, the odd last
    # node carried up
    count = n_leaves.clone()
    pos = idx
    while bool((count > 1).any()):
        c = count[msg]
        pair = (pos % 2 == 0) & (pos + 1 < c)
        keep = pos % 2 == 0
        left = torch.nonzero(pair).flatten()
        if len(left):
            lw, rw = cvs[left], cvs[left + 1]
            m = [lw[:, j] for j in range(8)] + [rw[:, j] for j in range(8)]
            root = c[left] == 2
            flags = PARENT | torch.where(root, ROOT, 0)
            z = torch.zeros(len(left), dtype=torch.int64, device=dev)
            cv = [torch.full_like(z, IV[i]) for i in range(8)]
            cvs[left] = torch.stack(compress(cv, m, z, z + BLOCK, flags), 1)
        cvs, msg, pos = cvs[keep], msg[keep], pos[keep] // 2
        count = (count + 1) // 2
    out = (cvs[:, 0] | (cvs[:, 1] << 32)).cpu().numpy()
    return out.view(np.uint64)


def hash64_bytes(messages: list) -> np.ndarray:
    """hash64 of a list of bytes objects, on the CPU."""
    lens = np.array([len(m) for m in messages], np.int64)
    starts = np.cumsum(lens) - lens
    buf = np.frombuffer(b"".join(messages) or b"\0", np.uint8)
    return hash64(torch.from_numpy(buf.copy()), starts, lens)
