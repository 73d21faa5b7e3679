"""Stage 1 of the chunk+hash data plane: HPCDC candidate scan and cut walk.

Port of ``longtail_tpu/parallel/stage1.py``.  A batch is ``lanes`` file
parts of ``part_bytes`` each, laid end to end in one uint8 tensor.

- ``scan`` (kernel ``csrc/stage1.cu`` lt_stage1_scan, plain
  ``scan_plain``) computes the 48-tap rolling hash at every position,
  marks cut candidates and reduces them to per-``Z``-byte-segment
  summaries ``(min1, min2, cnt)``: the two smallest candidate ends
  (absolute in the batch) and the candidate count.  With ``with_bins``
  the same pass also yields the fast compression tier's anchor bin-mins
  (``device_match.bin_mins_from_words`` over the batch's words).
- ``walk`` (kernel lt_stage1_walk, plain ``walk_plain``) resolves the
  min/max cut constraints per part over those summaries, giving
  ``(ends, n_chunks, ambiguous)`` per part, packed in one int32 tensor
  ``(lanes, c_pad + 2)`` so that one device-to-host copy fetches it.
  The plain version walks each part in order with ``suffix_min`` (each
  segment's smallest ``min1`` of the later segments of its part, as the
  JAX package computes it in XLA); the kernel compacts the candidates
  and walks all of them in parallel, and needs no suffix-min.

The summaries decide "first candidate end > q" exactly unless a segment
holds 3+ candidates and both kept ends precede the query; such a lane is
flagged and ``repair_lane`` re-chunks it exactly on the host.

For CPU tensors the wrappers compute the plain versions; for CUDA tensors
they launch the kernels or raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from longtail_tpu_torch import _kernels
from longtail_tpu_torch.formats.constants import CHUNKER_WINDOW_SIZE
from longtail_tpu_torch.ops import cdc
from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig
from longtail_tpu_torch.parallel.device_match import (
    BIN_WORDS,
    bin_mins_from_words,
)

WINDOW = CHUNKER_WINDOW_SIZE
BIG = 2**31 - 1
# part granularity: whole 256-byte runs of a scan-kernel thread
# (csrc/stage1.cu) and whole segments (Z <= 4096)
SCAN_TILE = 4096
WALK_CAP = 12288        # states a part keeps in the walk kernel's shared memory
_M = 0xFFFFFFFF

SOURCE = "longtail_tpu_torch/csrc/stage1.cu"
SCAN_REPLACES = "longtail_tpu/parallel/stage1.py:77"
WALK_REPLACES = "longtail_tpu/parallel/stage1.py:265"


def segment_bytes(cfg: ChunkerConfig) -> int:
    """Segment size Z: power of two ~ discriminator/16 so the expected
    candidate count per segment is ~0.06 (3+ candidates ~ 4e-5)."""
    d = cfg.discriminator
    z = 128
    while z * 32 <= d and z < 4096:
        z *= 2
    return z


@dataclasses.dataclass(frozen=True)
class Stage1Plan:
    """Static geometry for a (cfg, lanes, part_bytes) batch."""
    cfg: ChunkerConfig
    lanes: int
    part_bytes: int

    def __post_init__(self):
        if self.part_bytes % SCAN_TILE:
            raise ValueError(f"part_bytes {self.part_bytes} is not a "
                             f"multiple of {SCAN_TILE}")
        if self.lanes * self.part_bytes >= 2**31:
            raise ValueError("a batch must stay below 2 GiB (int32 ends)")

    @property
    def z(self) -> int:
        return segment_bytes(self.cfg)

    @property
    def segments_per_part(self) -> int:
        return self.part_bytes // self.z

    @property
    def c_pad(self) -> int:
        c = self.part_bytes // (self.cfg.min_size + 1) + 1
        return -(-c // 128) * 128


def scan_constants(d: int) -> tuple:
    """The scan kernel's candidate test for discriminator d, without a
    division: (inv, lim, shift).  With d = d0 * 2**shift, d0 odd, inv =
    d0**-1 mod 2**32 and n = (h * inv + inv) mod 2**32, a position is a
    candidate (h % d == d - 1, i.e. d divides h + 1) iff r = rotr(n,
    shift) <= lim = (2**32 - 1) // d, except that h = 2**32 - 1 (r = 0)
    qualifies only when d is a power of two (inv = 1).  The kernel sends
    a group of positions to that test when the least r of the group is
    <= lim, so only groups with a candidate (or r = 0) take it."""
    if not 0 < d <= _M:
        raise ValueError(f"discriminator {d} is not a positive u32")
    shift = (d & -d).bit_length() - 1
    return pow(d >> shift, -1, 2**32), _M // d, shift


def hash_table(device) -> torch.Tensor:
    """The HPCDC byte table as (256,) int32 on device (u32 bits)."""
    return torch.from_numpy(
        cdc.HASH_TABLE.astype(np.uint32).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------

def _rotl(x, r: int):
    r %= 32
    return x if r == 0 else ((x << r) | (x >> (32 - r))) & _M


def _shift_back(x, k: int):
    """out[p] = x[p - k] (0 for p < k)."""
    return torch.cat([torch.zeros(k, dtype=x.dtype, device=x.device),
                      x[:-k]])


def scan_plain(batch: torch.Tensor, lengths: torch.Tensor,
               table: torch.Tensor, plan: Stage1Plan,
               with_bins: bool = False):
    """Plain scan: (batch (lanes*part_bytes,) uint8, lengths (lanes,),
    table (256,) int32) -> (min1, min2, cnt), each (lanes*Sp,) int32,
    and with_bins the bin-mins (lanes*part_bytes/256,) int32 (u32 bits)."""
    P, z = plan.part_bytes, plan.z
    d = plan.cfg.discriminator
    tab = table.to(torch.int64) & _M
    lens = lengths.tolist()
    pos = torch.arange(P, device=batch.device, dtype=torch.int64)
    outs = []
    for b in range(plan.lanes):
        tv = tab[batch[b * P:(b + 1) * P].to(torch.int64)]
        # 48-tap window XOR by doubling: S_2k[p] = S_k[p] ^ rotl(S_k[p-k], k)
        s = tv
        for k in (1, 2, 4, 8):
            s = s ^ _rotl(_shift_back(s, k), k)
        s32 = s ^ _rotl(_shift_back(s, 16), 16)
        h = s ^ _rotl(_shift_back(s32, 16), 16)
        live = (h % d == d - 1) & (pos >= WINDOW - 1) & (pos < lens[b])
        ends = torch.where(live, pos + (b * P + 1), BIG).view(-1, z)
        m1 = ends.min(dim=1).values
        m2 = torch.where(ends == m1[:, None], BIG, ends).min(dim=1).values
        outs.append((m1, m2, live.view(-1, z).sum(dim=1)))
    out = tuple(torch.cat([o[i] for o in outs]).to(torch.int32)
                for i in range(3))
    if with_bins:
        out += (bin_mins_from_words(batch.view(torch.int32),
                                    plan.lanes * P // 4),)
    return out


def scan(batch: torch.Tensor, lengths: torch.Tensor, table: torch.Tensor,
         plan: Stage1Plan, with_bins: bool = False):
    """Scan kernel wrapper; same contract as scan_plain."""
    if batch.device.type == "cpu":
        return scan_plain(batch, lengths, table, plan, with_bins)
    n = plan.lanes * plan.part_bytes
    _kernels.require("batch", batch, torch.uint8, (n,))
    _kernels.require("lengths", lengths, torch.int32, (plan.lanes,),
                     batch.device)
    _kernels.require("table", table, torch.int32, (256,), batch.device)
    if batch.data_ptr() % 16:
        raise ValueError("batch: the scan kernel reads 16-byte aligned words")
    out = torch.empty((3, n // plan.z), dtype=torch.int32,
                      device=batch.device)
    bins = torch.empty((n // (4 * BIN_WORDS),), dtype=torch.int32,
                       device=batch.device) if with_bins else None
    with torch.cuda.device(batch.device):
        rc = _kernels.load().lt_stage1_scan(
            batch.data_ptr(), lengths.data_ptr(), table.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            None if bins is None else bins.data_ptr(), n,
            plan.part_bytes, plan.z.bit_length() - 1,
            *scan_constants(plan.cfg.discriminator),
            _kernels.stream_of(batch))
    _kernels.check(rc, "lt_stage1_scan")
    _kernels.count_launch(scan)
    if with_bins:
        return out[0], out[1], out[2], bins
    return out[0], out[1], out[2]


scan.LAUNCHES = 0


def suffix_min(min1: torch.Tensor, plan: Stage1Plan) -> torch.Tensor:
    """suf[s] = min of min1 over the later segments s' > s of the same
    part (BIG for a part's last segment)."""
    m = min1.view(plan.lanes, plan.segments_per_part)
    rev = torch.flip(torch.cummin(torch.flip(m, [1]), dim=1).values, [1])
    tail = torch.full((plan.lanes, 1), BIG, dtype=m.dtype, device=m.device)
    return torch.cat([rev[:, 1:], tail], dim=1).reshape(-1)


# ---------------------------------------------------------------------------
# walk
# ---------------------------------------------------------------------------

def walk_plain(lengths, min1, min2, cnt, suf, plan: Stage1Plan):
    """Plain walk (stage1.py lane_step, one part at a time) ->
    (lanes, c_pad + 2) int32: ends | n_chunks | ambiguous."""
    P, Sp, c_pad = plan.part_bytes, plan.segments_per_part, plan.c_pad
    mn, mx = plan.cfg.min_size, plan.cfg.max_size
    lgz = plan.z.bit_length() - 1
    lens = lengths.tolist()
    m1s, m2s, cns, sfs = (t.tolist() for t in (min1, min2, cnt, suf))
    out = np.zeros((plan.lanes, c_pad + 2), dtype=np.int32)
    for b in range(plan.lanes):
        L, off = lens[b], b * P
        s = n = amb = 0
        while s < L and n < c_pad:
            q = s + mn                      # first admissible end is > q
            g = b * Sp + min(q >> lgz, Sp - 1)
            qa = q + off
            m1, m2 = m1s[g], m2s[g]
            in_seg = m1 if m1 > qa else (m2 if m2 > qa else BIG)
            amb |= int(cns[g] >= 3 and m2 <= qa and m1 <= qa)
            e_cand = min(in_seg, sfs[g]) - off
            rem = L - s
            limit = s + mx if rem > mx else L
            e = min(e_cand if e_cand > q else limit, limit)
            if rem <= mn:
                e = L
            out[b, n] = e
            n += 1
            s = e
        out[b, c_pad] = n
        out[b, c_pad + 1] = amb
    return torch.from_numpy(out).to(lengths.device)


_SCRATCH: dict = {}


def walk_scratch(plan: Stage1Plan, device, stream: int = 0):
    """The walk kernel's global scratch for parts too dense for shared
    memory: per part, 4 int32 and 1 uint8 arrays of 2 * Sp + 2 states;
    (None, None) where no part of the plan can hold more than WALK_CAP
    states.  Kept per (geometry, device, stream): the launches of one
    stream run in order, so they share it."""
    stride = 2 * plan.segments_per_part + 2
    if stride <= WALK_CAP:
        return None, None
    key = (plan.lanes, stride, str(device), stream)
    if key not in _SCRATCH:
        n = plan.lanes * stride
        _SCRATCH[key] = (torch.empty(4 * n, dtype=torch.int32, device=device),
                         torch.empty(n, dtype=torch.uint8, device=device))
    return _SCRATCH[key]


def walk(lengths, min1, min2, cnt, plan: Stage1Plan):
    """Walk kernel wrapper; walk_plain's contract, from the summaries
    alone (the kernel needs no suffix-min; the plain version takes
    ``suffix_min`` of min1)."""
    if lengths.device.type == "cpu":
        return walk_plain(lengths, min1, min2, cnt, suffix_min(min1, plan),
                          plan)
    B, c_pad = plan.lanes, plan.c_pad
    n_seg = B * plan.segments_per_part
    dev = lengths.device
    _kernels.require("lengths", lengths, torch.int32, (B,))
    for name, t in (("min1", min1), ("min2", min2), ("cnt", cnt)):
        _kernels.require(name, t, torch.int32, (n_seg,), dev)
    stream = _kernels.stream_of(lengths)
    s32, s8 = walk_scratch(plan, dev, stream)
    out = torch.empty((B, c_pad + 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _kernels.load().lt_stage1_walk(
            lengths.data_ptr(), min1.data_ptr(), min2.data_ptr(),
            cnt.data_ptr(), None if s32 is None else s32.data_ptr(),
            None if s8 is None else s8.data_ptr(), out.data_ptr(), B,
            plan.part_bytes, plan.segments_per_part,
            plan.z.bit_length() - 1, plan.cfg.min_size, plan.cfg.max_size,
            c_pad, stream)
    _kernels.check(rc, "lt_stage1_walk")
    _kernels.count_launch(walk)
    return out


walk.LAUNCHES = 0


def stage1(batch: torch.Tensor, lengths: torch.Tensor, table: torch.Tensor,
           plan: Stage1Plan, with_bins: bool = False):
    """scan -> walk: (the (lanes, c_pad + 2) walk output, the scan's
    bin-mins with with_bins, else None)."""
    min1, min2, cnt, *bins = scan(batch, lengths, table, plan, with_bins)
    return (walk(lengths, min1, min2, cnt, plan),
            bins[0] if bins else None)


def unpack_walk(out: np.ndarray, plan: Stage1Plan):
    """Host view of the walk output -> (sizes (lanes, c_pad) int32 with 0
    past n_chunks, n_chunks, ambiguous)."""
    c_pad = plan.c_pad
    ends = out[:, :c_pad].astype(np.int64)
    n = out[:, c_pad].copy()
    amb = out[:, c_pad + 1].copy()
    starts = np.concatenate(
        [np.zeros((len(out), 1), np.int64), ends[:, :-1]], axis=1)
    idx = np.arange(c_pad)[None, :]
    sizes = np.where(idx < n[:, None], ends - starts, 0).astype(np.int32)
    return sizes, n, amb


def repair_lane(part_bytes_u8: np.ndarray, cfg: ChunkerConfig) -> np.ndarray:
    """Exact host re-chunk of one flagged lane; returns chunk sizes."""
    repair_lane.REPAIRS += 1
    ends = cdc.chunk_part(part_bytes_u8, cfg.min_size, cfg.avg_size,
                          cfg.max_size)
    return np.diff(np.concatenate([[0], ends])).astype(np.int32)


repair_lane.REPAIRS = 0
