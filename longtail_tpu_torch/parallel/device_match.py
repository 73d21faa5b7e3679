"""Device LZ match-anchor finding — port of
``longtail_tpu/parallel/device_match.py``.

The JAX package leaves this work to XLA (no Pallas kernel), so the port
runs it as plain PyTorch on whatever device the words lie on: batched
row sorts (``torch.sort`` on int64 keys) and a bin-min reduction.  The
same functions serve the CPU tests and the card.

Words are int32 tensors holding the little-endian u32 words of the
stream.  torch has no unsigned 32-bit arithmetic, so the gram hash and
every packed key ride as int64 masked to 32 bits; products are split so
that no intermediate leaves the int64 range.  Every sort key carries a
position, so keys are unique and no sort needs stability.

- ``anchor_rows`` (``make_anchor_fn``): the full-density tier, one
  sample per word, rows of ``ROW_WORDS`` words, three batched row sorts.
- ``fast_anchors`` (``make_fast_anchor_fn``): the fast tier, one
  content-defined sample per 64-word bin (``bin_mins_from_words``), then
  ``_anchors_from_bin_mins`` per block.
- ``fast_anchors_packed`` / ``bins_anchors_packed``
  (``make_fast_anchor_packed_fn`` / ``make_bins_anchor_packed_fn``):
  the single-fetch ``(blocks, 2*cap + 1)`` form of the fast tier, from
  words or from the stage-1 scan's bin-mins.
- ``fast_block_anchors``: the fast tier's host-facing entry; the
  full-density tier's is ``parallel/device_lz4.block_anchors``.

Anchors are hints: the host assemblers memcmp-validate and byte-extend
every one, so a hash collision costs ratio, never correctness.
"""

from __future__ import annotations

import numpy as np
import torch

_POS_BITS = 14
_POS_MASK = (1 << _POS_BITS) - 1

ROW_WORDS = 1 << _POS_BITS   # samples per sort row = 64 KiB of data
MAX_ANCHORS = 2048       # compacted anchors kept per row

BIN_WORDS = 64           # one sampled anchor per 64 words (256 B)
FAST_CAP = 4096          # anchors kept per block
_GPOS_BITS = 22          # block word-position bits (<= 16 MiB blocks)

_M = 0xFFFFFFFF
GRAM_H0 = 0x9E3779B1     # gram-hash multipliers (also csrc/stage1.cu)
GRAM_H1 = 0x85EBCA77


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without leaving the
    int64 range: the product is split at bit 16 of c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.reshape(-1).to(torch.int64) & _M


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bits."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _gram_hash(w: torch.Tensor, k: int) -> torch.Tensor:
    """Hash of the 8-byte gram at each of the first k words of the u32
    stream w (int64): the next word is 0 after word k - 1."""
    w0 = w[:k]
    w1 = torch.cat([w[1:k], w.new_zeros(1)])
    return (_mul32(w0, GRAM_H0) ^ (_mul32(w1, GRAM_H1) >> 13)
            ^ ((w1 << 7) & _M))


def _prev(a: torch.Tensor) -> torch.Tensor:
    """Each row shifted right by one column, column 0 kept."""
    return torch.cat([a[:, :1], a[:, :-1]], dim=1)


def _sort_rows(key: torch.Tensor, *payload: torch.Tensor):
    ks, idx = torch.sort(key, dim=1)
    return (ks, *(torch.gather(p, 1, idx) for p in payload))


# ---------------------------------------------------------------------------
# full-density tier
# ---------------------------------------------------------------------------

def anchor_rows(words: torch.Tensor):
    """(n_words,) int32 word stream -> (packed (S, MAX_ANCHORS) int64 u32
    values, counts (S,) int32) with S = n_words // ROW_WORDS; the
    counterpart of ``make_anchor_fn``.

    packed[s, j] for j < counts[s] encodes an anchor of row s: bits
    [14, 28) = sample position within the row, bits [0, 14) = the
    matching earlier sample position.  Entries past counts[s] have bit
    28 set.  Trailing words beyond S * ROW_WORDS are ignored."""
    n = words.numel()
    S = n // ROW_WORDS
    if S < 1:
        raise ValueError(f"{n} words do not fill a row of {ROW_WORDS}")
    K = S * ROW_WORDS
    h = _gram_hash(_u32(words), K).view(S, ROW_WORDS)
    pos = torch.arange(ROW_WORDS, device=words.device,
                       dtype=torch.int64).expand(S, ROW_WORDS)
    key = ((h >> _POS_BITS) << _POS_BITS) | pos
    ks, hs = _sort_rows(key, h)
    col0 = pos == 0
    cand = ~col0 & ((ks >> _POS_BITS) == (_prev(ks) >> _POS_BITS)) \
        & (hs == _prev(hs))
    spos = ks & _POS_MASK
    sref = _prev(ks) & _POS_MASK
    key2 = torch.where(cand, 0, 1 << 28) | (spos << _POS_BITS) | sref
    s2, _ = torch.sort(key2, dim=1)
    apos = (s2 >> _POS_BITS) & _POS_MASK
    aref = s2 & _POS_MASK
    valid = (s2 >> 28) == 0
    # valid entries lead each row in ascending position, so the u32
    # differences of device_match.py are exact small signed values here
    dpos = apos - _prev(apos)
    dref = aref - _prev(aref)
    chain = valid & _prev(valid) & (dpos == dref) & (dpos >= 1) & (dpos <= 2)
    keep = valid & ~chain
    key3 = torch.where(keep, 0, 1 << 28) | (apos << _POS_BITS) | aref
    s3 = torch.sort(key3, dim=1)[0][:, :MAX_ANCHORS]
    counts = torch.clamp(keep.sum(dim=1), max=MAX_ANCHORS).to(torch.int32)
    return s3, counts


# ---------------------------------------------------------------------------
# fast tier: content-defined bin-sampled anchors (1/BIN_WORDS density)
# ---------------------------------------------------------------------------

def bin_mins_from_words(words: torch.Tensor, K: int) -> torch.Tensor:
    """(>= K words) int32 stream -> (K // BIN_WORDS,) int32 holding the u32
    packed per-bin argmin: top 26 bits = min gram hash, low 6 = its word
    position within the bin.  The next word of the last gram is 0."""
    h = _gram_hash(_u32(words), K).view(-1, BIN_WORDS)
    pos6 = torch.arange(BIN_WORDS, device=words.device, dtype=torch.int64)
    packed = (h & ~(BIN_WORDS - 1)) | pos6
    return _to_int32(packed.min(dim=1).values)


def _anchors_from_bin_mins(m: torch.Tensor, nblk: int, nbins_b: int,
                           cap: int, max_offset_words: int,
                           suppress_sampled_chains: bool):
    """The anchor-extraction tail of the fast tier over (nblk * nbins_b,)
    bin-mins (int32 u32 bits) -> (pos (nblk, min(cap, nbins_b)) int32,
    ref (same) int32, counts (nblk,) int32)."""
    lg = BIN_WORDS.bit_length() - 1
    m = (m.reshape(nblk, nbins_b).to(torch.int64) & _M)
    hmin = m >> lg                              # 26-bit min-hash
    binpos = torch.arange(nbins_b, device=m.device,
                          dtype=torch.int64) << lg
    gpos = (binpos + (m & (BIN_WORDS - 1))) & _M
    # lexicographic (hmin, gpos) as one key: gpos < 2**gbits per block
    gbits = max(_GPOS_BITS, (nbins_b * BIN_WORDS - 1).bit_length())
    ks, ps = _sort_rows((hmin << gbits) | gpos, gpos)
    hs = ks >> gbits
    col = torch.arange(nbins_b, device=m.device).expand(nblk, nbins_b)
    cand = (col > 0) & (hs == _prev(hs)) & \
        (ps - _prev(ps) <= max_offset_words)
    key2 = (torch.where(cand, 0, 1 << _GPOS_BITS) | ps) & _M
    k2, ref = _sort_rows(key2, _prev(ps))
    apos = k2 & ((1 << _GPOS_BITS) - 1)
    valid = (k2 >> _GPOS_BITS) == 0
    # as in anchor_rows: among valid neighbours the u32 differences are
    # exact signed values, so signed comparisons decide the same
    dpos = apos - _prev(apos)
    dref = ref - _prev(ref)
    pv = valid & _prev(valid) & (dpos >= 1)
    chain = pv & (dpos == dref) & (dpos <= 4 * BIN_WORDS)
    if suppress_sampled_chains:
        chain = chain | (pv & (ref == _prev(apos)))
    keep = valid & ~chain
    key3 = torch.where(keep, 0, 1 << _GPOS_BITS) | apos
    k3, ref3 = _sort_rows(key3, ref)
    k3, ref3 = k3[:, :cap], ref3[:, :cap]
    valid3 = (k3 >> _GPOS_BITS) == 0
    counts = torch.clamp(keep.sum(dim=1), max=cap).to(torch.int32)
    pos_out = _to_int32(torch.where(valid3, k3, 0))
    ref_out = _to_int32(torch.where(valid3, ref3, 0))
    return pos_out, ref_out, counts


def fast_anchors(words: torch.Tensor, block_words: int, cap: int = FAST_CAP,
                 max_offset_words: int = 16383,
                 suppress_sampled_chains: bool = True):
    """(n_words,) int32 words -> (pos, ref, counts) per block of
    ``block_words`` (a trailing partial block is zero-padded); the
    counterpart of ``make_fast_anchor_fn``.  ``max_offset_words`` bounds
    the match distance (16383 words = the LZ4 64 KiB window; block_words
    for zstd's whole-block window)."""
    if block_words % BIN_WORDS:
        raise ValueError(f"block_words {block_words} is not a multiple of "
                         f"{BIN_WORDS}")
    words = words.reshape(-1)
    nblk = max(1, -(-words.numel() // block_words))
    K = nblk * block_words
    if K > words.numel():
        words = torch.cat([words, words.new_zeros(K - words.numel())])
    m = bin_mins_from_words(words, K)
    return _anchors_from_bin_mins(m, nblk, block_words // BIN_WORDS, cap,
                                  max_offset_words, suppress_sampled_chains)


def _packed(pos, ref, counts) -> torch.Tensor:
    return torch.cat([pos, ref, counts[:, None]], dim=1)


def fast_anchors_packed(words: torch.Tensor, block_words: int,
                        cap: int = FAST_CAP,
                        max_offset_words: int = 16383) -> torch.Tensor:
    """Single-output form of fast_anchors: (blocks, 2*cap' + 1) int32 =
    [pos row | ref row | count] per block (``make_fast_anchor_packed_fn``)."""
    return _packed(*fast_anchors(words, block_words, cap, max_offset_words))


def bins_anchors_packed(bins: torch.Tensor, bins_per_block: int,
                        cap: int = FAST_CAP, max_offset_words: int = 16383,
                        suppress_sampled_chains: bool = True) -> torch.Tensor:
    """Anchor extraction straight from per-bin packed mins (the stage-1
    scan's bins output), (n_bins,) int32 -> (blocks, 2*cap' + 1) int32
    (``make_bins_anchor_packed_fn``).  A trailing partial block is padded
    with 0xFFFFFFFF bins: they pair only among themselves or past the
    real data, where the host assembler's memcmp rejects them."""
    m = bins.reshape(-1)
    nblk = -(-m.numel() // bins_per_block)
    pad = nblk * bins_per_block - m.numel()
    if pad:
        m = torch.cat([m, m.new_full((pad,), -1)])
    return _packed(*_anchors_from_bin_mins(
        m, nblk, bins_per_block, cap, max_offset_words,
        suppress_sampled_chains))


def fast_block_anchors(words: torch.Tensor, block_words: int,
                       cap: int = FAST_CAP, max_offset_words: int = 16383,
                       suppress_sampled_chains: bool = True):
    """One-shot fast-tier scan: per-block position-sorted
    (pos_bytes, ref_bytes) int64 numpy anchor lists."""
    pos, ref, counts = fast_anchors(words, block_words, cap,
                                    max_offset_words,
                                    suppress_sampled_chains)
    return decode_packed(_packed(pos, ref, counts).cpu().numpy())


def decode_packed(arr: np.ndarray):
    """(blocks, 2*cap + 1) [pos | ref | count] rows -> per-block
    (pos_bytes, ref_bytes) int64 arrays."""
    cap = (arr.shape[1] - 1) // 2
    out = []
    for b in range(arr.shape[0]):
        c = int(arr[b, -1])
        out.append((arr[b, :c].astype(np.int64) * 4,
                    arr[b, cap:cap + c].astype(np.int64) * 4))
    return out
