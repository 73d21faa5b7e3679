"""The zstd literals' Huffman stage on a torch device, and the frame
assembly around it — port of ``longtail_tpu/ops/device_entropy.py``.

Division of labour, as in the JAX package:

- **Histograms on the device** (``device_histograms``): byte frequencies
  of each literal section over a bounded strided sample (plain
  ``torch.bincount``; the JAX package left it to XLA too).
- **Table build on the host**: the length-limited canonical Huffman code
  of ``zstd_frame.build_huffman`` (``ops/zstd_frame.py``), the code the
  from-spec frame codec uses, so the streams stay upstream-decodable.
- **Bit pack on the device** (``pack_streams`` through
  ``ops/entropy_kernel.hufpack_frame``, kernel 5): the backward Huffman
  bitstream of each stream.

The JAX package runs the stage once per literal section, each with its
round trips.  The literal sections of a frame are all known before the
frame is built, so ``encode_sections`` runs it once per frame: one
histogram call for every section that needs one and one pack launch for
every Huffman stream, each with one upload and one wait.  Each section's
bytes equal ``zstd_frame._encode_literals``'s choices byte for byte (raw
and RLE choices, the 1-vs-4-stream split, the jump table);
``encode_literals_device`` is a frame of one section, and
``frame_from_sequences`` builds one standard zstd frame from externally
found sequences, falling back to a raw block where a block's entropy
stage fails or does not shrink it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from longtail_tpu_torch.ops import zstd_frame
from longtail_tpu_torch.ops.zstd_frame import BLOCK_MAX, ZstdError
from longtail_tpu_torch.ops.entropy_kernel import (
    frame_inputs,
    hufpack_frame,
    pack_code_table,
    words_per_stream,
)


_HIST_SAMPLE = 1 << 16     # histogram sample cap (64 KiB)


def _pinned(device) -> bool:
    return torch.device(device).type == "cuda"


def _wait(device) -> None:
    """Wait for the work queued so far on device's current stream."""
    if _pinned(device):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(torch.device(device)))
        ev.synchronize()


def device_histograms(sections: list[np.ndarray], device) -> np.ndarray:
    """Byte frequencies of each section for the table build, (k, 256)
    int64, in one call: exact for a section of up to _HIST_SAMPLE bytes,
    a strided sample (as upstream zstd takes) past it.  One upload of the
    samples and their counts, one torch.bincount over section * 256 +
    byte, one download."""
    k = len(sections)
    if k == 0:
        return np.zeros((0, 256), np.int64)
    samples = [a[:: -(-len(a) // _HIST_SAMPLE)] if len(a) > _HIST_SAMPLE
               else a for a in sections]
    counts = np.array([len(x) for x in samples], np.int64)
    total = int(counts.sum())
    blob = torch.empty((8 * k + total,), dtype=torch.uint8,
                       pin_memory=_pinned(device))
    b = blob.numpy()
    b[:8 * k] = counts.view(np.uint8)
    np.concatenate(samples, out=b[8 * k:])
    blob = blob.to(device, non_blocking=True)
    section = torch.repeat_interleave(
        torch.arange(k, device=blob.device), blob[:8 * k].view(torch.int64),
        output_size=total)
    keys = section * 256 + blob[8 * k:].to(torch.int64)
    return torch.bincount(keys, minlength=256 * k).view(k, 256).cpu().numpy()


def _freqs(arr: np.ndarray, hist: np.ndarray) -> list:
    """A section's frequencies for build_huffman: a sampled histogram may
    miss rare symbols, and every literal present must have a code, so
    past _HIST_SAMPLE exact presence is backfilled."""
    freqs = hist.tolist()
    if len(arr) > _HIST_SAMPLE:
        for s in np.flatnonzero(np.bincount(arr, minlength=256)):
            if freqs[s] == 0:
                freqs[s] = 1
    return freqs


def pack_streams(jobs: list, device) -> list[list[bytes]]:
    """Pack the literal streams of jobs [(parts, table from
    pack_code_table)] on the device in one hufpack_frame launch, with one
    upload of the frame's inputs and one wait for its outputs; returns,
    per job, its streams' host bytes with the sentinel bit appended
    (BackBitWriter.close semantics)."""
    if not jobs:
        return []
    lits, streams, tables, n_words = frame_inputs(jobs)
    S, K = len(streams), len(tables)
    head = streams.nbytes + tables.nbytes           # a multiple of 16
    blob = torch.empty((head + len(lits),), dtype=torch.uint8,
                       pin_memory=_pinned(device))
    b = blob.numpy()
    b[:streams.nbytes] = streams.reshape(-1).view(np.uint8)
    b[streams.nbytes:head] = tables.reshape(-1).view(np.uint8)
    b[head:] = lits
    blob = blob.to(device, non_blocking=True)
    words, totals = hufpack_frame(
        blob[head:], blob[:streams.nbytes].view(torch.int32).view(S, 4),
        blob[streams.nbytes:head].view(torch.int32).view(K, 256), n_words)
    out = torch.empty((S + n_words,), dtype=torch.int32,
                      pin_memory=_pinned(device))
    out[:S].copy_(totals, non_blocking=True)
    out[S:].copy_(words, non_blocking=True)
    _wait(device)
    o = out.numpy().view(np.uint32)
    packed = []
    for (_, n, _, woff), t in zip(streams.tolist(), o[:S].tolist()):
        w = o[S + woff:S + woff + words_per_stream(n)].copy()
        w[t >> 5] |= np.uint32(1 << (t & 31))        # sentinel bit
        packed.append(w.tobytes()[: (t + 1 + 7) // 8])
    res, s = [], 0
    for parts, _ in jobs:
        res.append(packed[s:s + len(parts)])
        s += len(parts)
    return res


def huffman_jobs(sections: list[bytes], device):
    """Every literals section's choice before the pack, byte-compatible
    with zstd_frame._encode_literals: (sections' bytes, raw, RLE or
    empty, for now; {section index: Huffman tree description} of the
    sections that take a table; the pack jobs [(streams, table)] of those
    sections, in the same order).  One device_histograms call for every
    section that needs a table, then build_huffman per section on the
    host."""
    hdr = zstd_frame._pack_literals_header
    out: list = [None] * len(sections)
    cand = {}                   # section index -> literals for a table
    for i, lits in enumerate(sections):
        n = len(lits)
        if n == 0:
            out[i] = hdr(0, 0, None, False)
        elif n >= 2 and lits.count(lits[0]) == n:
            out[i] = hdr(1, n, None, False) + lits[:1]
        else:
            out[i] = hdr(0, n, None, False) + lits        # raw
            if n >= 64:
                cand[i] = np.frombuffer(lits, np.uint8)
    jobs, tree_descs = [], {}
    for (i, arr), hist in zip(cand.items(),
                              device_histograms(list(cand.values()), device)):
        built = zstd_frame.build_huffman(_freqs(arr, hist))
        if built is None:
            continue
        weights, code_val, code_len = built
        try:
            tree_descs[i] = zstd_frame.write_huffman_weights(weights[:-1])
        except ZstdError:
            continue
        n = len(arr)
        if n > 1023:
            seg = (n + 3) // 4
            parts = [arr[0:seg], arr[seg:2 * seg], arr[2 * seg:3 * seg],
                     arr[3 * seg:]]
        else:
            parts = [arr]
        jobs.append((parts, pack_code_table(code_val, code_len)))
    return out, tree_descs, jobs


def encode_sections(sections: list[bytes], device) -> list[bytes]:
    """Literals sections with the Huffman stage on ``device``, each
    byte-compatible with zstd_frame._encode_literals: huffman_jobs, then
    one pack_streams call for every Huffman stream; a Huffman section
    that does not come out shorter than its raw one stays raw."""
    out, tree_descs, jobs = huffman_jobs(sections, device)
    hdr = zstd_frame._pack_literals_header
    for i, streams in zip(tree_descs, pack_streams(jobs, device)):
        four = len(streams) == 4
        if four:
            body = struct.pack("<3H", len(streams[0]), len(streams[1]),
                               len(streams[2])) + b"".join(streams)
        else:
            body = streams[0]
        comp = len(tree_descs[i]) + len(body)
        h = hdr(2, len(sections[i]), comp, four)
        if len(h) + comp < len(out[i]):
            out[i] = h + tree_descs[i] + body
    return out


def encode_literals_device(lits: bytes, device) -> bytes:
    """Literals section with the Huffman stage on ``device``,
    byte-compatible with zstd_frame._encode_literals: a frame of one
    section."""
    return encode_sections([lits], device)[0]


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
    sequences, with the literals sections of all its blocks through the
    Huffman stage on ``device`` at once (encode_sections).  Decodable by
    upstream zstd and ``zstd_frame.decompress``."""
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

    blocks = list(literal_sections(src, seq_rows))
    sections = encode_sections([lits for _, _, lits in blocks], device)
    rep = [1, 4, 8]
    pos = 0
    for (blen, seqs, _), section in zip(blocks, sections):
        last = 1 if pos + blen == n else 0
        rep_try = list(rep)
        try:
            payload = section + zstd_frame._encode_sequences(seqs, rep_try)
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
