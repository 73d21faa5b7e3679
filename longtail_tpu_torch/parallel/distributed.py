"""The all-gather dedup steps across processes — the port of
``longtail_tpu/parallel/distributed.py`` in torch's SPMD idiom.

The JAX package shards a batch's lanes over a device mesh with
``shard_map``; here every rank of a ``torch.distributed`` process group
calls the step with its own ``(B/n, P)`` lanes on its own device:

- each rank chunks and hashes its lanes (``device_chunker.index_parts``:
  the stage-1 kernels and BLAKE3 on the device of the lanes);
- the ranks ``all_gather`` their chunk-hash lists and each sorts and
  uniques the combined set, so every rank holds the same (replicated)
  unique set, in the JAX function's shapes and order.

The collectives run on the tensors' device: gloo for CPU tensors, NCCL
for CUDA tensors.  A group whose backend does not serve the device
raises; no step moves a tensor to another device or backend.  Hash words
travel as int64 (gloo has no unsigned 32- or 64-bit tensors), and the
sort key is ``((hi ^ 2**31) << 32) | lo``, whose signed order is the
unsigned (hi, lo) order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from longtail_tpu_torch.parallel.device_chunker import (
    ChunkerConfig,
    index_parts,
)

_BACKEND_OF = {"cpu": "gloo", "cuda": "nccl"}


def _check_backend(t: torch.Tensor, group) -> None:
    """Raise unless the group's backend for t's device is gloo (CPU) or
    NCCL (CUDA)."""
    name = str(dist.get_backend(group))
    per_device = dict(x.split(":") for x in name.split(",")) \
        if ":" in name else {"cpu": name, "cuda": name}
    want = _BACKEND_OF.get(t.device.type)
    if want is None or per_device.get(t.device.type) != want:
        raise ValueError(
            f"a collective on a {t.device.type} tensor needs the {want} "
            f"backend; the process group has {name!r}")


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t (same shape on every rank), concatenated along dim
    0 in rank order: JAX's all_gather(tiled=True)."""
    _check_backend(t, group)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out)


def _dedup(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor):
    """Sorted unique (hi, lo) pairs of the valid entries, compacted to the
    front of zeros of the input's length, and their count (int32).  Valid
    entries sort before padding among equal keys, so the first of a key
    group is valid whenever the group holds a valid entry (the JAX
    package's lexsort((~valid, lo, hi)))."""
    key = ((hi ^ 0x80000000) << 32) | lo
    pre = torch.argsort((~valid).to(torch.int8), stable=True)
    order = pre[torch.argsort(key[pre], stable=True)]
    key_s, valid_s = key[order], valid[order]
    first = torch.ones_like(valid_s)
    first[1:] = key_s[1:] != key_s[:-1]
    keep = first & valid_s
    n = keep.sum()
    uniq_lo, uniq_hi = torch.zeros_like(lo), torch.zeros_like(hi)
    uniq_lo[:n] = lo[order][keep]
    uniq_hi[:n] = hi[order][keep]
    return uniq_lo, uniq_hi, n.to(torch.int32)


def sharded_index_step(parts: torch.Tensor, lengths, cfg: ChunkerConfig,
                       group=None):
    """The full distributed step: chunk + hash this rank's lanes, then
    all-gather and globally dedup the chunk hashes.

    parts: this rank's (B/n, P) uint8 lanes on its device; lengths: (B/n,).
    Returns (ends (B/n, C) int32, sizes (B/n, C) int32, uniq_lo (N,),
    uniq_hi (N,), uniq_count () int32), N = n * (B/n) * C, the unique
    words as int64 and zero past uniq_count; the unique set is the same
    on every rank."""
    ends, sizes, lo, hi = index_parts(parts, lengths, cfg)
    valid = (sizes.reshape(-1) > 0).to(torch.int64)
    g = _all_gather(torch.stack([lo, hi, valid]).t(), group)
    uniq_lo, uniq_hi, n_uniq = _dedup(g[:, 0], g[:, 1], g[:, 2] > 0)
    return ends, sizes, uniq_lo, uniq_hi, n_uniq


def sharded_chunk_step(parts: torch.Tensor, lengths, cfg: ChunkerConfig,
                       dedup_slots: int, group=None):
    """The production step: chunk + hash this rank's lanes and run the
    global-dedup all-gather over the compacted hash list, at most
    ``dedup_slots`` entries a rank.  A rank with more chunks than that
    keeps the first ``dedup_slots`` and raises the overflow count, so the
    caller can dedup on the host instead.

    Returns (sizes (B/n, C) int32, lo (B/n, C), hi (B/n, C) [this rank's,
    int64, zero where sizes == 0], uniq_lo, uniq_hi (n * dedup_slots,)
    int64 [replicated], n_uniq () int32, overflow () int32: the number of
    ranks that overflowed)."""
    K = int(dedup_slots)
    _, sizes, lo, hi = index_parts(parts, lengths, cfg)
    valid = sizes.reshape(-1) > 0
    n_valid = int(valid.sum())
    n_local = min(n_valid, K)
    own = torch.zeros((2 * K + 2,), dtype=torch.int64, device=parts.device)
    own[:n_local] = lo[valid][:n_local]
    own[K:K + n_local] = hi[valid][:n_local]
    own[2 * K] = n_local
    own[2 * K + 1] = int(n_valid > K)
    g = _all_gather(own[None], group)
    slot = torch.arange(K, device=parts.device)
    valid_g = (slot[None, :] < g[:, 2 * K, None]).reshape(-1)
    uniq_lo, uniq_hi, n_uniq = _dedup(g[:, :K].reshape(-1),
                                      g[:, K:2 * K].reshape(-1), valid_g)
    overflow = g[:, 2 * K + 1].sum().to(torch.int32)
    return (sizes, lo.reshape(sizes.shape), hi.reshape(sizes.shape),
            uniq_lo, uniq_hi, n_uniq, overflow)


def default_dedup_slots(cfg: ChunkerConfig, lanes_per_dev: int,
                        part_bytes: int) -> int:
    """~4x the expected chunk count per rank, capped at the worst case."""
    worst = lanes_per_dev * cfg.max_chunks(part_bytes)
    expected = lanes_per_dev * (4 * part_bytes // cfg.avg_size + 8)
    return int(min(worst, expected))


def host_unique_hashes(lo, hi, count) -> np.ndarray:
    """The replicated unique words (tensors or arrays, u32 values in any
    integer dtype) as host uint64 hashes, the first ``count``."""
    def words(x):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return (x.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)

    h = (words(hi) << np.uint64(32)) | words(lo)
    return h[: int(count)]
