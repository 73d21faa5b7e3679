"""Batched LZ4 block decode on a torch device — the port of
``longtail_tpu/parallel/device_decode.py``.

A device cannot walk an LZ4 token stream byte by byte, so decode is
re-derived as data-parallel index algebra:

1. **Host parse** (``parse_sequences``): one O(sequences) walk of the
   token structure, copying no data, gives per-sequence (literal source,
   literal dest, literal length, match dest, offset, match length).
2. **Device resolve** (``make_resolve_fn``): every output byte finds its
   segment with one ``torch.searchsorted`` over the interleaved segment
   starts.  A literal byte resolves to a compressed-stream index; a
   match byte to an EARLIER output index (overlapping matches use
   ``ref + (j - dst) % offset``, which lands before the match start, so
   chains strictly decrease).  Rounds of pointer-jumping gathers then
   chase match pointers until every byte reaches a literal, and one last
   gather reads the output.

The JAX package computes this with XLA ops and no Pallas kernel, so the
port is plain torch ops.  Pointer jumping doubles the resolved chain
length each round, so a block of n bytes resolves within ceil(log2(n))
+ 1 rounds; a pointer still unresolved after them is an error, not a
slow block, and raises (the JAX package falls back to the host decoder
after 64 rounds).  No downsync path runs this module: downsync decodes
on the host (``ops/lz4.decompress_into``).
"""

from __future__ import annotations

import numpy as np
import torch

from longtail_tpu_torch.utils.device import resolve_device

_MINMATCH = 4


def parse_sequences(comp: bytes, raw_size: int):
    """Parse an LZ4 block's token structure (no data movement).

    Returns (lit_src, lit_dst, lit_len, m_dst, m_off, m_len) int32
    arrays, one row per sequence; the final literal-only tail is a row
    with m_len = 0."""
    n = len(comp)
    ip = 0
    dst = 0
    rows = []
    while ip < n:
        token = comp[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = comp[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        lit_src = ip
        ip += lit
        if ip >= n:
            rows.append((lit_src, dst, lit, dst + lit, 0, 0))
            dst += lit
            break
        off = comp[ip] | (comp[ip + 1] << 8)
        ip += 2
        mlen = (token & 15) + _MINMATCH
        if (token & 15) == 15:
            while True:
                b = comp[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        rows.append((lit_src, dst, lit, dst + lit, off, mlen))
        dst += lit + mlen
    if dst != raw_size:
        raise ValueError(f"lz4 parse: {dst} != expected {raw_size}")
    out = np.asarray(rows, dtype=np.int32).reshape(-1, 6)
    return (out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4],
            out[:, 5])


def max_rounds(n_out: int) -> int:
    """Pointer-jumping rounds that resolve any chain among n_out bytes."""
    return max(n_out - 1, 1).bit_length() + 1


def make_resolve_fn(n_out: int, n_seq: int):
    """(comp u8 (n_comp,), the six sequence arrays (n_seq,) int32, sorted
    by destination) -> (out u8 (n_out,), rounds used), on the tensors'
    device.  Sequences past the block's own may be padding rows with
    lit_len = m_len = 0 and destinations at the block's end, as the JAX
    package pads them; output bytes past the block are then don't-care.
    Raises if a pointer is unresolved after max_rounds(n_out)."""
    limit = max_rounds(n_out)

    def fn(comp, lit_src, lit_dst, lit_len, m_dst, m_off, m_len):
        if lit_dst.shape != (n_seq,):
            raise ValueError(f"sequences: ({n_seq},) expected, got "
                             f"{tuple(lit_dst.shape)}")
        dev = comp.device
        j = torch.arange(n_out, dtype=torch.int32, device=dev)
        # interleaved segment starts: [lit_dst_0, m_dst_0, lit_dst_1, ..]
        starts = torch.stack([lit_dst, m_dst], dim=1).reshape(-1)
        k = torch.searchsorted(starts, j, right=True, out_int32=True) - 1
        i = k >> 1
        is_lit = (k & 1) == 0
        md = m_dst[i]
        off = m_off[i].clamp(min=1)
        # literal bytes resolve into the compressed stream at once; match
        # bytes point at strictly earlier output positions
        lit_idx = lit_src[i] + (j - lit_dst[i])
        match_idx = md - off + torch.remainder(j - md, off)
        idx = torch.where(is_lit, lit_idx, match_idx)
        flag = ~is_lit                          # True: idx is an OUT index
        rounds = 0
        while bool(flag.any()):
            if rounds == limit:
                raise RuntimeError(
                    f"device LZ4 decode: pointers unresolved after {limit} "
                    f"rounds of pointer jumping over {n_out} bytes: the "
                    "block or its parse is corrupt")
            # pointer JUMPING: every flagged byte reads through the
            # partly resolved snapshot, so the chain distance doubles
            safe = idx.clamp(0, n_out - 1)
            idx, flag = torch.where(flag, idx[safe], idx), flag & flag[safe]
            rounds += 1
        out = comp[idx.clamp(0, comp.numel() - 1)]
        return out, rounds

    return fn


def decode_block_device(comp: bytes, raw_size: int,
                        device="cuda") -> bytes:
    """Decode one LZ4 block on ``device`` (the card by default, "cpu" for
    the same torch ops on the CPU); bit-exact with the host decoder."""
    dev = resolve_device(device)
    if raw_size == 0:
        return b""
    seq = parse_sequences(comp, raw_size)
    comp_t = torch.from_numpy(np.frombuffer(comp, np.uint8).copy()).to(dev)
    seq_t = [torch.from_numpy(a).to(dev) for a in seq]
    out, _ = make_resolve_fn(raw_size, len(seq[0]))(comp_t, *seq_t)
    return out.cpu().numpy().tobytes()
