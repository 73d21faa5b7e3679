"""The card's peaks, the least time of a kernel's work, and the work that
a job gives the stage-1 and BLAKE3 kernels.

Frozen copies from ``chip_smoke.py``: the peaks and operation counts
(chip_smoke.py:150-178) and ``bound`` (:184-191).  They live here so
that a later change to the program cannot change the yardstick.

The work is counted from the chunk sizes of the version index that the
job produced, never from launch shapes, so it is the same whatever
implements the kernels.  Only assets larger than ``DEVICE_PATH_MIN``
go through the card (``core/indexing.py:222``: small_cutoff = max(the
chunker's max size, part bytes / 64), 512 KiB at a 32 KiB target); the
smaller ones are chunked and hashed on the host.
"""

from __future__ import annotations

import struct

import numpy as np

# the card's peaks for the bounds: HBM3 of an H100 SXM (NVIDIA's data
# sheet), and its int32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (NVIDIA's Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * CLOCK_HZ
# integer operations per 64-byte compression: 8 G functions per round of
# 12 operations each, 7 rounds, and the 8 output words
BLAKE3_OPS = 7 * 8 * 12 + 8
# ALU operations per scanned byte: the rolling update (a rotate and a
# 3-input xor) and the candidate test without a division (one IMAD and
# half of a 3-input min); the table lookups are shared-memory loads
SCAN_OPS = 3.5
BLAKE3_LEAF = 1024
BLAKE3_BLOCK = 64


def device_path_min(target_chunk_size: int) -> int:
    """Assets of more bytes than this go through the card."""
    return max(target_chunk_size * 2, target_chunk_size * 1024 // 64)


def bound(n_bytes: float, int_ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes the
    function must move over HBM and its integer operations over the
    card's int32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_chunks(lvi: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(sizes of the assets that go through the card, sizes of their
    chunks in file order, repeats included) from a .lvi."""
    _, _, target, n_assets, n_chunks, n_refs = struct.unpack_from("<6I",
                                                                  lvi, 0)
    off = 24 + 16 * n_assets
    sizes = np.frombuffer(lvi, "<u8", n_assets, off).astype(np.int64)
    off += 8 * n_assets
    counts = np.frombuffer(lvi, "<u4", n_assets, off).astype(np.int64)
    starts = np.frombuffer(lvi, "<u4", n_assets, off + 4 * n_assets) \
        .astype(np.int64)
    off += 8 * n_assets
    refs = np.frombuffer(lvi, "<u4", n_refs, off).astype(np.int64)
    off += 4 * n_refs + 8 * n_chunks
    chunk_sizes = np.frombuffer(lvi, "<u4", n_chunks, off).astype(np.int64)
    big = np.flatnonzero(sizes > device_path_min(target))
    per = [chunk_sizes[refs[starts[a]:starts[a] + counts[a]]] for a in big]
    return sizes[big], (np.concatenate(per) if per
                        else np.zeros(0, np.int64))


def stage1_work(asset_sizes, chunk_sizes) -> tuple[float, float]:
    """(bytes, operations) of the scan and walk: every byte read once, 4
    bytes written per chunk boundary, SCAN_OPS operations per byte."""
    n = float(np.sum(asset_sizes))
    return n + 4.0 * len(chunk_sizes), SCAN_OPS * n


def blake3_compressions(chunk_sizes) -> int:
    """64-byte compressions that BLAKE3 needs for chunks of these sizes:
    each 1 KiB leaf's blocks (at least one) and one parent per leaf but
    the first."""
    s = np.asarray(chunk_sizes, np.int64)
    leaves = np.maximum(-(-s // BLAKE3_LEAF), 1)
    full = s // BLAKE3_LEAF
    rest = s - full * BLAKE3_LEAF
    blocks = full * (BLAKE3_LEAF // BLAKE3_BLOCK) + np.where(
        rest > 0, -(-rest // BLAKE3_BLOCK), np.where(full == 0, 1, 0))
    return int(blocks.sum() + (leaves - 1).sum())


def blake3_work(chunk_sizes) -> tuple[float, float]:
    """(bytes, operations) of the BLAKE3 kernel: every chunk byte read
    once and 8 bytes written per digest."""
    s = np.asarray(chunk_sizes, np.int64)
    return (float(s.sum()) + 8.0 * len(s),
            float(blake3_compressions(s)) * BLAKE3_OPS)

