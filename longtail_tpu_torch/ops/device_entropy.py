"""The zstd literals' Huffman stage on a torch device, and the frame
assembly around it — port of ``longtail_tpu/ops/device_entropy.py``.

Division of labour, as in the JAX package:

- **Histogram on the device** (``device_histogram``): byte frequencies of
  the literals over a bounded strided sample (plain ``torch.bincount``;
  the JAX package left it to XLA too).
- **Table build on the host**: the length-limited canonical Huffman code
  of ``zstd_frame.build_huffman`` (``ops/zstd_frame.py``), the code the
  from-spec frame codec uses, so the streams stay upstream-decodable.
- **Bit pack on the device** (``ops/entropy_kernel.hufpack``, kernel 5):
  the backward Huffman bitstream of each stream.

``encode_literals_device`` mirrors ``zstd_frame._encode_literals`` byte
for byte (raw and RLE choices, the 1-vs-4-stream split, the jump table),
and ``frame_from_sequences`` builds one standard zstd frame from
externally found sequences, falling back to a raw block where a block's
entropy stage fails or does not shrink it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from longtail_tpu_torch.ops import zstd_frame
from longtail_tpu_torch.ops.zstd_frame import BLOCK_MAX, ZstdError
from longtail_tpu_torch.ops.entropy_kernel import hufpack, pack_code_table


_HIST_SAMPLE = 1 << 16     # histogram sample cap (64 KiB)


def device_histogram(lits: np.ndarray, device) -> np.ndarray:
    """Byte frequencies for the table build: exact for small inputs, a
    strided sample (as upstream zstd does) past _HIST_SAMPLE."""
    n = len(lits)
    if n > _HIST_SAMPLE:
        lits = lits[:: -(-n // _HIST_SAMPLE)]
    x = torch.from_numpy(np.array(lits)).to(device)
    return torch.bincount(x.to(torch.int32), minlength=256).cpu().numpy()


def stream_inputs(parts: list[np.ndarray], code_val, code_len):
    """The pack's inputs for literal streams: (lits (S, n_pad) uint8 with
    n_pad the power of two >= the longest stream (at least 256), n_lit
    (S,) int32, table (256,) int32)."""
    n_pad = 1 << max(8, (max(len(p) for p in parts) - 1).bit_length())
    lits = np.zeros((len(parts), n_pad), np.uint8)
    n_lit = np.zeros((len(parts),), np.int32)
    for i, p in enumerate(parts):
        lits[i, : len(p)] = p
        n_lit[i] = len(p)
    return lits, n_lit, pack_code_table(code_val, code_len)


def _pack_streams_device(parts: list[np.ndarray], code_val, code_len,
                         device) -> list[bytes]:
    """Pack each literal stream on the device; returns host byte strings
    with the sentinel bit appended (BackBitWriter.close semantics)."""
    words, totals = hufpack(*(torch.from_numpy(a).to(device) for a in
                              stream_inputs(parts, code_val, code_len)))
    words = words.cpu().numpy().view(np.uint32)
    totals = totals.cpu().numpy()
    out = []
    for w, t in zip(words, totals.tolist()):
        w = w.copy()
        w[t >> 5] |= np.uint32(1 << (t & 31))        # sentinel bit
        out.append(w.tobytes()[: (t + 1 + 7) // 8])
    return out


def encode_literals_device(lits: bytes, device) -> bytes:
    """Literals section with the Huffman stage on ``device``,
    byte-compatible with zstd_frame._encode_literals."""
    n = len(lits)
    hdr = zstd_frame._pack_literals_header
    if n == 0:
        return hdr(0, 0, None, False)
    if n >= 2 and lits.count(lits[0]) == n:
        return hdr(1, n, None, False) + lits[:1]
    raw = hdr(0, n, None, False) + lits
    if n < 64:
        return raw
    arr = np.frombuffer(lits, np.uint8)
    freqs = device_histogram(arr, device).tolist()
    # a sampled histogram may miss rare symbols, and every literal present
    # must have a code: backfill exact presence
    if n > _HIST_SAMPLE:
        present = np.flatnonzero(np.bincount(arr, minlength=256))
        for s in present:
            if freqs[s] == 0:
                freqs[s] = 1
    built = zstd_frame.build_huffman(freqs)
    if built is None:
        return raw
    weights, code_val, code_len = built
    try:
        tree_desc = zstd_frame.write_huffman_weights(weights[:-1])
    except ZstdError:
        return raw
    four = n > 1023
    if four:
        seg = (n + 3) // 4
        parts = [arr[0:seg], arr[seg:2 * seg], arr[2 * seg:3 * seg],
                 arr[3 * seg:]]
        streams = _pack_streams_device(parts, code_val, code_len, device)
        body = struct.pack("<3H", len(streams[0]), len(streams[1]),
                           len(streams[2])) + b"".join(streams)
    else:
        body = _pack_streams_device([arr], code_val, code_len, device)[0]
    comp = len(tree_desc) + len(body)
    h = hdr(2, n, comp, four)
    if len(h) + comp >= len(raw):
        return raw
    return h + tree_desc + body


# ---------------------------------------------------------------------------
# frame assembly from externally found sequences
# ---------------------------------------------------------------------------

def _split_blocks(seq_rows, n: int):
    """Slice a whole-input sequence list into <= BLOCK_MAX zstd blocks.

    seq_rows: (m, 4) u32 ZSTD_Sequence rows (offset, litLength,
    matchLength, rep) covering src in order; bytes no sequence covers are
    literals.  Returns [(block_len, [(ll, ml, off)], tail_literal_bytes)]:
    a match straddling a block boundary splits, or degrades to literals
    where a side would fall under zstd's 3-byte minimum match.  Offsets may
    reach before the block start: the frame window is the whole input."""
    rows = [(int(r[1]), int(r[2]), int(r[0])) for r in seq_rows]
    covered = sum(ll + ml for ll, ml, _ in rows)
    if covered < n:
        rows.append((n - covered, 0, 0))

    blocks = []
    cur: list = []      # sequences of the open block
    cur_tail = 0        # literal bytes after the open block's last seq
    bstart = 0
    c = 0               # absolute cursor

    def close():
        nonlocal bstart, cur, cur_tail
        blocks.append((c - bstart, cur, cur_tail))
        bstart = c
        cur = []
        cur_tail = 0

    i = 0
    while i < len(rows):
        ll, ml, off = rows[i]
        be = bstart + min(BLOCK_MAX, n - bstart)
        if c + ll + ml <= be:                    # fits entirely
            if ml > 0:
                cur.append((ll, ml, off))
            else:
                cur_tail += ll
            c += ll + ml
            i += 1
            if c == be and c < n:
                close()
            continue
        if c + ll >= be:                         # literal run crosses
            head = be - c
            cur_tail += head
            c = be
            rows[i] = (ll - head, ml, off)
            close()
            continue
        m1 = be - (c + ll)                       # match crosses
        m2 = ml - m1
        if m1 >= 3:
            cur.append((ll, m1, off))
        else:
            cur_tail += ll + m1                  # too short: literals
        rows[i] = (0, m2, off) if m2 >= 3 else (m2, 0, 0)
        c = be
        close()
    if c > bstart or not blocks:
        close()
    return blocks


def literal_sections(src: bytes, seq_rows):
    """(block_len, [(ll, ml, off)], literal bytes) per zstd block of
    _split_blocks: the literals each block's section encodes."""
    pos = 0
    for blen, seqs, tail_lits in _split_blocks(seq_rows, len(src)):
        parts = []
        c = pos
        for ll, ml, _ in seqs:
            parts.append(src[c:c + ll])
            c += ll + ml
        parts.append(src[c:c + tail_lits])
        yield blen, seqs, b"".join(parts)
        pos += blen


def frame_from_sequences(src: bytes, seq_rows, device) -> bytes:
    """One standard zstd frame for ``src`` from externally found
    sequences, with each block's literals section through the Huffman
    stage on ``device``.  Decodable by upstream zstd and
    ``zstd_frame.decompress``."""
    n = len(src)
    out = bytearray(zstd_frame.MAGIC.to_bytes(4, "little"))
    if n <= 255:
        out.append((0 << 6) | (1 << 5))
        out.append(n)
    elif n - 256 <= 0xFFFF:
        out.append((1 << 6) | (1 << 5))
        out += (n - 256).to_bytes(2, "little")
    else:
        out.append((2 << 6) | (1 << 5))
        out += n.to_bytes(4, "little")
    if n == 0:
        out += (1).to_bytes(3, "little")
        return bytes(out)

    rep = [1, 4, 8]
    pos = 0
    for blen, seqs, lits in literal_sections(src, seq_rows):
        last = 1 if pos + blen == n else 0
        rep_try = list(rep)
        try:
            payload = encode_literals_device(lits, device) + \
                zstd_frame._encode_sequences(seqs, rep_try)
        except ZstdError:
            payload = None
        if payload is not None and len(payload) < blen:
            out += ((last | (2 << 1) | (len(payload) << 3))
                    ).to_bytes(3, "little")
            out += payload
            rep = rep_try
        else:
            out += ((last | (0 << 1) | (blen << 3))).to_bytes(3, "little")
            out += src[pos:pos + blen]
        pos += blen
    return bytes(out)
