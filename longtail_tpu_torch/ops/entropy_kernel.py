"""The backward Huffman bit pack of the zstd literals: the wrappers of
``csrc/hufpack.cu`` and their plain PyTorch versions.

The counterpart of ``longtail_tpu/ops/entropy_kernel.py``
(``make_hufpack_rows_fn``, the Pallas bit-merge kernel) and of the XLA
scatter formulation it replaced (``device_entropy._make_hufpack_xla``).
A block of the kernels packs a piece of at most ``MAX_STREAM_LITS``
literals (its words live in one block's shared memory):

- ``hufpack_frame(lits, streams, tables, n_words)``: every Huffman
  stream of a zstd frame, each with its own section's code table, in one
  launch (the zstd device tier's path; a 128 KiB zstd block's four
  streams are each one piece);
- ``hufpack(lits, n_lit, table)``: rows of one table and any length, the
  JAX package's ``(S, n_pad)`` interface, each row cut into pieces
  (``row_pieces``) that two launches pack: one sums each piece's code
  lengths, the next packs each piece at the bit total of the pieces after
  it in its row.

For a CPU tensor each wrapper computes its plain version
(``hufpack_frame_plain``, ``hufpack_pieces_plain``); for a CUDA tensor it
launches the kernels or raises.  The TPU's ``MIN_PALLAS_PAD`` and ``% 128``
guards are Mosaic's rules, not the card's.

Contract (RFC 8878 §4.2.1, ``hufpack_plain``): stream s's literal i has
its code at bit offset sum(len[j] for i < j < n_lit[s]), bits stacked
LSB-up, exactly the pattern of ``zstd_frame._huf_encode_stream`` before
its sentinel bit.
"""

from __future__ import annotations

import numpy as np
import torch

from longtail_tpu_torch import _kernels
from longtail_tpu_torch.ops.zstd_frame import BLOCK_MAX, MAX_HUF_BITS


SOURCE = "longtail_tpu_torch/csrc/hufpack.cu"
REPLACES = "longtail_tpu/ops/entropy_kernel.py:120"

_M = 0xFFFFFFFF

# literals of one stream the kernel takes (its words live in one block's
# shared memory): a 128 KiB zstd block's literals split into four streams
MAX_STREAM_LITS = BLOCK_MAX // 4
LIT_ALIGN = 16              # every stream starts at a 16-byte offset


def words_per_stream(n_pad: int) -> int:
    """W: output words per stream of n_pad literal slots (every code at
    most MAX_HUF_BITS bits, plus a spill word)."""
    return (n_pad * MAX_HUF_BITS + 31) // 32 + 1


def pack_code_table(code_val, code_len) -> np.ndarray:
    """Canonical codes (lists of up to 256 entries) -> (256,) int32
    entries val | len << 16; raises on a code longer than MAX_HUF_BITS
    (the output bound of both versions rests on it)."""
    cv = np.zeros(256, np.int64)
    cl = np.zeros(256, np.int64)
    cv[: len(code_val)] = code_val
    cl[: len(code_len)] = code_len
    if cl.max() > MAX_HUF_BITS or cl.min() < 0 or (cv >> cl).any():
        raise ValueError("code table: lengths must lie in "
                         f"[0, {MAX_HUF_BITS}] and values fit them")
    return (cv | (cl << 16)).astype(np.int32)


def hufpack_plain(lits: torch.Tensor, n_lit: torch.Tensor,
                  table: torch.Tensor):
    """Plain pack: (lits (S, n_pad) uint8, n_lit (S,) int32, table (256,)
    int32 from pack_code_table) -> (words (S, W) int32 holding u32 bits,
    totals (S,) int32 bit counts).

    Code bits of different literals are disjoint, so a scatter-add of each
    literal's two shifted word contributions equals their OR."""
    S, n_pad = lits.shape
    W = words_per_stream(n_pad)
    tab = table.to(torch.int64)
    b = lits.to(torch.int64)
    idx = torch.arange(n_pad, device=lits.device)[None, :]
    live = idx < n_lit.to(device=lits.device, dtype=torch.int64)[:, None]
    L = torch.where(live, tab[b] >> 16, 0)
    V = torch.where(live, tab[b] & 0xFFFF, 0)
    csum = torch.cumsum(L, dim=1)
    total = csum[:, -1]
    bitoff = total[:, None] - csum            # offset of literal i
    sh = bitoff & 31
    lo = (V << sh) & _M
    hi = V >> (32 - sh)                      # spill; 0 when sh == 0
    w0 = bitoff >> 5
    acc = torch.zeros((S, W + 1), dtype=torch.int64, device=lits.device)
    acc.scatter_add_(1, w0, lo)
    acc.scatter_add_(1, w0 + 1, hi)
    words = acc[:, :W]
    return ((words - ((words & 0x80000000) << 1)).to(torch.int32),
            total.to(torch.int32))


def frame_inputs(sections):
    """The frame pack's inputs for sections [(parts, table)]: parts a list
    of uint8 literal streams, table (256,) int32 from pack_code_table.
    Returns (lits uint8, every stream at a LIT_ALIGN offset and the length
    a multiple of it; streams (S, 4) int32 rows (literal offset, n_lit,
    table index, word offset), word offsets packing words_per_stream(n_lit)
    words a stream; tables (K, 256) int32; n_words, the words of all)."""
    parts = [p for ps, _ in sections for p in ps]
    streams = np.zeros((len(parts), 4), np.int32)
    lit_off = word_off = 0
    s = 0
    for k, (ps, _) in enumerate(sections):
        for p in ps:
            streams[s] = (lit_off, len(p), k, word_off)
            lit_off += -(-len(p) // LIT_ALIGN) * LIT_ALIGN
            word_off += words_per_stream(len(p))
            s += 1
    lits = np.zeros(lit_off, np.uint8)
    for (off, n, _, _), p in zip(streams.tolist(), parts):
        lits[off:off + n] = p
    tables = np.zeros((len(sections), 256), np.int32)
    for k, (_, t) in enumerate(sections):
        tables[k] = t
    return lits, streams, tables, word_off


def hufpack_frame_plain(lits: torch.Tensor, streams: torch.Tensor,
                        tables: torch.Tensor, n_words: int):
    """Plain frame pack: (lits uint8, streams (S, 4), tables (K, 256)
    int32, n_words) as frame_inputs lays them out -> (words (n_words,)
    int32 holding u32 bits, stream s's hufpack_plain words at its word
    offset; totals (S,) int32 bit counts).  Words no stream covers are 0."""
    dev = lits.device
    words = torch.zeros((n_words,), dtype=torch.int32, device=dev)
    totals = torch.zeros((streams.shape[0],), dtype=torch.int32, device=dev)
    for s, (off, n, k, woff) in enumerate(streams.cpu().tolist()):
        if n == 0:
            continue
        w, t = hufpack_plain(lits[off:off + n][None],
                             torch.tensor([n], dtype=torch.int32), tables[k])
        words[woff:woff + words_per_stream(n)] = w[0]
        totals[s] = t[0]
    return words, totals


def hufpack_frame(lits: torch.Tensor, streams: torch.Tensor,
                  tables: torch.Tensor, n_words: int):
    """Kernel wrapper; same contract as hufpack_frame_plain, except that
    words past a stream's words_per_stream(n_lit) and covered by no
    stream are left unwritten (frame_inputs leaves none)."""
    if lits.device.type == "cpu":
        return hufpack_frame_plain(lits, streams, tables, n_words)
    dev = lits.device
    S, K = streams.shape[0], tables.shape[0]
    _kernels.require("lits", lits, torch.uint8)
    _kernels.require("streams", streams, torch.int32, (S, 4), dev)
    _kernels.require("tables", tables, torch.int32, (K, 256), dev)
    if lits.dim() != 1 or lits.numel() % LIT_ALIGN or \
            lits.data_ptr() % LIT_ALIGN:
        raise ValueError("lits: a 1-D byte tensor of 16-byte aligned "
                         "16-byte words is needed")
    words = torch.empty((n_words,), dtype=torch.int32, device=dev)
    totals = torch.empty((S,), dtype=torch.int32, device=dev)
    if S:
        with torch.cuda.device(dev):
            rc = _kernels.load().lt_hufpack(
                lits.data_ptr(), lits.numel(), streams.data_ptr(),
                tables.data_ptr(), words.data_ptr(), totals.data_ptr(), S, K,
                n_words, _kernels.stream_of(lits))
        _kernels.check(rc, "lt_hufpack")
        _kernels.count_launch(hufpack_frame)
    return words, totals


hufpack_frame.LAUNCHES = 0


def pieces_per_row(n_pad: int) -> int:
    """M: the pieces of MAX_STREAM_LITS literals a row of n_pad takes (at
    least one, so that every row's total is written)."""
    return max(1, -(-n_pad // MAX_STREAM_LITS))


def row_pieces(n_lit: torch.Tensor, n_pad: int) -> torch.Tensor:
    """The piece list of S rows of n_pad literal slots: (S * M, 4) int32
    rows (first literal in the rows laid end to end, literals, row,
    pieces after it in its row), M = pieces_per_row(n_pad), piece m of
    row s at literal m * MAX_STREAM_LITS of the row with its share of
    n_lit[s] (0 past it).  Computed on n_lit's device, with no read of
    n_lit on the host."""
    S, M = n_lit.shape[0], pieces_per_row(n_pad)
    piece = torch.arange(S * M, dtype=torch.int32, device=n_lit.device)
    row, m = piece // M, piece % M
    first = m * MAX_STREAM_LITS
    n = (n_lit.to(torch.int32).clamp(0, n_pad)[row]
         - first).clamp(0, MAX_STREAM_LITS)
    return torch.stack([row * n_pad + first, n, row, M - 1 - m],
                       dim=1).contiguous()


def _check_rows(lits: torch.Tensor) -> None:
    S, n_pad = lits.shape
    if n_pad <= 0 or n_pad % LIT_ALIGN:
        raise ValueError(f"rows of {n_pad} literals: a positive multiple "
                         f"of {LIT_ALIGN} is needed")
    if S * n_pad >= 1 << 31 or n_pad * MAX_HUF_BITS >= 1 << 31:
        raise ValueError(f"{S} rows of {n_pad} literals: the kernels "
                         "address literals and a row's bits in int32")


def hufpack_pieces_plain(lits: torch.Tensor, n_lit: torch.Tensor,
                         table: torch.Tensor):
    """Plain version of hufpack's kernels, on its piece list: each piece
    packed alone (hufpack_plain), its bit offset the total of the pieces
    after it in its row, its words shifted there and added, which equals
    their OR (the bits are disjoint).  Same contract as hufpack_plain."""
    _check_rows(lits)
    S, n_pad = lits.shape
    dev = lits.device
    pieces = row_pieces(n_lit.to(dev), n_pad).to(torch.int64)
    P, L = pieces.shape[0], min(n_pad, MAX_STREAM_LITS)
    Wp, W = words_per_stream(L), words_per_stream(n_pad)
    flat = torch.nn.functional.pad(lits.reshape(-1), (0, L))
    at = pieces[:, :1] + torch.arange(L, device=dev)
    words, bits = hufpack_plain(flat[at], pieces[:, 1], table)
    words = words.to(torch.int64) & _M
    bits = bits.to(torch.int64)
    csum = torch.cumsum(bits, 0)
    off = csum[torch.arange(P, device=dev) + pieces[:, 3]] - csum
    sh = (off & 31)[:, None]
    # a piece's last word is at most W - 1 of its row (+1 for its spill)
    at = (pieces[:, 2:3] * (W + 1) + (off >> 5)[:, None]
          + torch.arange(Wp, device=dev))
    acc = torch.zeros((S * (W + 1),), dtype=torch.int64, device=dev)
    acc.scatter_add_(0, at.reshape(-1), ((words << sh) & _M).reshape(-1))
    acc.scatter_add_(0, (at + 1).reshape(-1),
                     (words >> (32 - sh)).reshape(-1))
    out = acc.view(S, W + 1)[:, :W]
    totals = torch.zeros((S,), dtype=torch.int64, device=dev)
    totals.index_add_(0, pieces[:, 2], bits)
    return ((out - ((out & 0x80000000) << 1)).to(torch.int32),
            totals.to(torch.int32))


def hufpack(lits: torch.Tensor, n_lit: torch.Tensor, table: torch.Tensor):
    """Kernel wrapper of the (S, n_pad) interface: same contract as
    hufpack_plain, for any positive n_pad that is a multiple of
    LIT_ALIGN.  On a CUDA tensor: the piece list (row_pieces, a few small
    ops), then one entry point that zeroes the words, sums each piece's
    code lengths and packs each piece in place (a memset and two kernel
    launches, counted once)."""
    if lits.device.type == "cpu":
        return hufpack_pieces_plain(lits, n_lit, table)
    _check_rows(lits)
    S, n_pad = lits.shape
    dev = lits.device
    _kernels.require("lits", lits, torch.uint8, (S, n_pad), dev)
    if lits.data_ptr() % LIT_ALIGN:
        raise ValueError("lits: 16-byte aligned rows are needed")
    table = table.to(device=dev, dtype=torch.int32).contiguous()
    _kernels.require("table", table, torch.int32, (256,), dev)
    pieces = row_pieces(n_lit.to(dev), n_pad)
    P, W = pieces.shape[0], words_per_stream(n_pad)
    bits = torch.empty((P,), dtype=torch.int32, device=dev)
    words = torch.empty((S, W), dtype=torch.int32, device=dev)
    totals = torch.empty((S,), dtype=torch.int32, device=dev)
    if S:
        with torch.cuda.device(dev):
            rc = _kernels.load().lt_hufpack_rows(
                lits.data_ptr(), lits.numel(), pieces.data_ptr(),
                table.data_ptr(), bits.data_ptr(), words.data_ptr(),
                totals.data_ptr(), P, S, W, _kernels.stream_of(lits))
        _kernels.check(rc, "lt_hufpack_rows")
        _kernels.count_launch(hufpack)
    return words, totals


hufpack.LAUNCHES = 0
