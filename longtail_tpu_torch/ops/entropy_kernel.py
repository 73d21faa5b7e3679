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
  JAX package's ``(S, n_pad)`` interface, each row cut into pieces of
  ``MAX_STREAM_LITS`` literals that one launch packs: each piece at the
  bit total of the pieces after it in its row, learnt from their
  published totals within the launch (``hufpack_pieces_plain`` follows
  the same scheme on ``row_pieces``).

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

import threading

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
    """Plain version of hufpack's kernel, in its scheme, on the piece list
    (row_pieces): each piece packed alone at bit 0 (hufpack_plain); its
    bit offset the total of the pieces after it in its row, its inclusive
    total that plus its own; its words moved to its shift, off & 31; its
    edge word the part of it in word incl >> 5.  Piece m stores the words
    [off >> 5, incl >> 5), its first ORed with the edge words of the later
    pieces that reach into it; the row's first piece also the word the
    row's total ends in (the edge words that reach it) and zeros past it.
    Same contract as hufpack_plain."""
    _check_rows(lits)
    S, n_pad = lits.shape
    dev = lits.device
    pieces = row_pieces(n_lit.to(dev), n_pad).to(torch.int64)
    M, L = pieces_per_row(n_pad), min(n_pad, MAX_STREAM_LITS)
    W = words_per_stream(n_pad)
    flat = torch.nn.functional.pad(lits.reshape(-1), (0, L))
    at = pieces[:, :1] + torch.arange(L, device=dev)
    words, bits = hufpack_plain(flat[at], pieces[:, 1], table)
    words = words.to(torch.int64) & _M
    bits = bits.to(torch.int64).view(S, M)
    incl = bits.flip(1).cumsum(1).flip(1)     # its bits and the later's
    off = incl - bits
    sh = (off & 31).reshape(-1, 1)
    moved = (torch.nn.functional.pad((words << sh) & _M, (0, 1))
             | torch.nn.functional.pad(words >> (32 - sh), (1, 0)))
    edge = moved.gather(1, ((incl >> 5) - (off >> 5)).reshape(-1, 1))
    w0, w1 = (off >> 5).tolist(), (incl >> 5).tolist()
    off, incl, edge = off.tolist(), incl.tolist(), edge.view(S, M).tolist()

    def edges_into(s, k0, w):               # the later pieces' bits in w
        word = 0
        for k in range(k0, M):
            if incl[s][k] <= 32 * w:
                break
            word |= edge[s][k]
        return word

    first = [[edges_into(s, m + 1, w0[s][m])
              if off[s][m] & 31 and w0[s][m] < w1[s][m] else 0
              for m in range(M)] for s in range(S)]
    moved[:, 0] |= torch.tensor(first, dtype=torch.int64,
                                device=dev).reshape(-1)
    out = torch.zeros((S, W), dtype=torch.int64, device=dev)
    for s in range(S):
        for m in range(M):
            out[s, w0[s][m]:w1[s][m]] = moved[s * M + m,
                                              :w1[s][m] - w0[s][m]]
        if incl[s][0] & 31:
            out[s, w1[s][0]] = edge[s][0] | edges_into(s, 1, w1[s][0])
    totals = torch.tensor([row[0] for row in incl], dtype=torch.int64,
                          device=dev)
    return ((out - ((out & 0x80000000) << 1)).to(torch.int32),
            totals.to(torch.int32))


# the rows kernel's work buffer of each (device, stream): [buffer, epoch
# of its last call, ticket base of its next]; a call holds the lock from
# taking its epoch and base to its launch, so calls queue in that order
_ROWS_WORK: dict = {}
_ROWS_LOCK = threading.Lock()
_EPOCHS = (1 << 31) - 1                     # epochs 1 .. 2^31 - 1
# words of a slice of a row's zeros, past its total, that one block of
# the rows kernel stores (16 a thread)
ZERO_WORDS = 16 * 1024


def rows_work_words(n_pieces: int) -> int:
    """int64 words of the rows kernel's work buffer for n_pieces pieces:
    its ticket counter, a status word and a 32-bit edge word a piece."""
    return 1 + n_pieces + -(-n_pieces // 2)


def hufpack(lits: torch.Tensor, n_lit: torch.Tensor, table: torch.Tensor):
    """Kernel wrapper of the (S, n_pad) interface: same contract as
    hufpack_plain, for any positive n_pad that is a multiple of
    LIT_ALIGN.  On a CUDA tensor: one launch of the rows kernel, which
    finds its pieces from its tickets, n_lit and n_pad, and nothing else
    on the device (n_lit and table already int32 on lits' device; the
    stream's work buffer is zeroed only when first made or grown)."""
    if lits.device.type == "cpu":
        return hufpack_pieces_plain(lits, n_lit, table)
    _check_rows(lits)
    S, n_pad = lits.shape
    dev = lits.device
    _kernels.require("lits", lits, torch.uint8, (S, n_pad), dev)
    if lits.data_ptr() % LIT_ALIGN:
        raise ValueError("lits: 16-byte aligned rows are needed")
    n_lit = n_lit.to(device=dev, dtype=torch.int32).contiguous()
    _kernels.require("n_lit", n_lit, torch.int32, (S,), dev)
    table = table.to(device=dev, dtype=torch.int32).contiguous()
    _kernels.require("table", table, torch.int32, (256,), dev)
    P, W = S * pieces_per_row(n_pad), words_per_stream(n_pad)
    tickets = P + S * -(-W // ZERO_WORDS)   # a block a piece and a slice
    words = torch.empty((S, W), dtype=torch.int32, device=dev)
    totals = torch.empty((S,), dtype=torch.int32, device=dev)
    if not S:
        return words, totals
    stream = _kernels.stream_of(lits)
    with _ROWS_LOCK:
        key = (dev.index, stream)
        work = _ROWS_WORK.get(key)
        if work is None or work[0].numel() < rows_work_words(P):
            work = _ROWS_WORK[key] = [torch.zeros(
                (rows_work_words(P),), dtype=torch.int64, device=dev), 0, 0]
        epoch = work[1] % _EPOCHS + 1
        with torch.cuda.device(dev):
            rc = _kernels.load().lt_hufpack_rows(
                lits.data_ptr(), n_lit.data_ptr(), table.data_ptr(),
                words.data_ptr(), totals.data_ptr(), work[0].data_ptr(), S,
                n_pad, W, ZERO_WORDS, epoch, work[2], stream)
        if rc:                              # refused: the counter is as it was
            del _ROWS_WORK[key]
        else:
            work[1], work[2] = epoch, (work[2] + tickets) & 0xFFFFFFFF
    _kernels.check(rc, "lt_hufpack_rows")
    _kernels.count_launch(hufpack)
    return words, totals


hufpack.LAUNCHES = 0
