"""The backward Huffman bit pack of the zstd literals: the wrapper of
``csrc/hufpack.cu`` and its plain PyTorch version.

The counterpart of ``longtail_tpu/ops/entropy_kernel.py``
(``make_hufpack_rows_fn``, the Pallas bit-merge kernel) and of the XLA
scatter formulation it replaced (``device_entropy._make_hufpack_xla``),
with the dispatch of ``device_entropy.make_hufpack_fn``: ``hufpack``
computes ``hufpack_plain`` for a CPU tensor and launches the kernel for
a CUDA tensor, at every ``n_pad`` (the TPU's ``MIN_PALLAS_PAD`` and
``% 128`` guards are Mosaic's rules, not the card's).

Contract (RFC 8878 §4.2.1): stream s's literal i has its code at bit
offset sum(len[j] for i < j < n_lit[s]), bits stacked LSB-up, exactly the
pattern of ``zstd_frame._huf_encode_stream`` before its sentinel bit.
"""

from __future__ import annotations

import numpy as np
import torch

from longtail_tpu_torch import _kernels
from longtail_tpu_torch.ops.zstd_frame import MAX_HUF_BITS


SOURCE = "longtail_tpu_torch/csrc/hufpack.cu"
REPLACES = "longtail_tpu/ops/entropy_kernel.py:120"

_M = 0xFFFFFFFF


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


def hufpack(lits: torch.Tensor, n_lit: torch.Tensor, table: torch.Tensor):
    """Kernel wrapper; same contract as hufpack_plain."""
    if lits.device.type == "cpu":
        return hufpack_plain(lits, n_lit, table)
    S, n_pad = lits.shape
    _kernels.require("lits", lits, torch.uint8)
    _kernels.require("n_lit", n_lit, torch.int32, (S,), lits.device)
    _kernels.require("table", table, torch.int32, (256,), lits.device)
    W = words_per_stream(n_pad)
    words = torch.zeros((S, W), dtype=torch.int32, device=lits.device)
    totals = torch.empty((S,), dtype=torch.int32, device=lits.device)
    if S:
        with torch.cuda.device(lits.device):
            rc = _kernels.load().lt_hufpack(
                lits.data_ptr(), n_lit.data_ptr(), table.data_ptr(),
                words.data_ptr(), totals.data_ptr(), S, n_pad, W,
                _kernels.stream_of(lits))
        _kernels.check(rc, "lt_hufpack")
        _kernels.count_launch(hufpack)
    return words, totals


hufpack.LAUNCHES = 0
