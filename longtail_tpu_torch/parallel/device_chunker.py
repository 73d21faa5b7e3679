"""Chunking geometry of the device data plane, and the single-step
``index_parts``.

Of ``longtail_tpu/parallel/device_chunker.py`` this ports ``ChunkerConfig``
and ``index_parts``'s contract.  The JAX package computes ``index_parts``
with its earlier XLA chunker; the port computes it with the production
data plane instead (the stage-1 scan and walk kernels, the host repair
of ambiguous lanes, the BLAKE3 kernel), through one
``DevicePartIndexer`` batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from longtail_tpu_torch.formats.constants import chunker_params_from_target
from longtail_tpu_torch.ops.cdc import discriminator_from_avg

_LEAF = 1024


@dataclasses.dataclass(frozen=True)
class ChunkerConfig:
    """HPCDC (min, avg, max) chunk sizes."""
    min_size: int
    avg_size: int
    max_size: int

    @classmethod
    def from_target(cls, target_chunk_size: int) -> "ChunkerConfig":
        mn, av, mx = chunker_params_from_target(
            target_chunk_size)
        return cls(mn, av, mx)

    @property
    def discriminator(self) -> int:
        return discriminator_from_avg(float(self.avg_size))

    def max_chunks(self, part_bytes: int) -> int:
        # every chunk but the last spans >= min_size + 1 bytes
        return part_bytes // (self.min_size + 1) + 1

    @property
    def padded_chunk(self) -> int:
        return -(-self.max_size // _LEAF) * _LEAF


def index_parts(parts: torch.Tensor, lengths, cfg: ChunkerConfig):
    """Chunk + hash every lane of ``parts`` on its device: (B, P) uint8
    parts, (B,) lengths -> (ends (B, C) int32, sizes (B, C) int32,
    hash_lo (B*C,) int64, hash_hi (B*C,) int64), C = cfg.max_chunks(P),
    all on parts' device.

    Chunk i of lane b covers [ends[b, i-1], ends[b, i]); slots past a
    lane's last chunk are padding: size 0, end the lane's length (where
    the JAX package's ``resolve_ends`` leaves a finished lane), hash words
    0.  The hash words are the u32 halves of each chunk's BLAKE3-64,
    carried in int64."""
    from longtail_tpu_torch.parallel.pipeline import DevicePartIndexer
    from longtail_tpu_torch.parallel.stage1 import SCAN_TILE

    if parts.dim() != 2 or parts.dtype != torch.uint8:
        raise ValueError("parts: a (B, P) uint8 tensor is needed")
    B, P = parts.shape
    C = cfg.max_chunks(P)
    dev = parts.device
    lens = np.asarray(lengths.cpu() if torch.is_tensor(lengths) else lengths,
                      dtype=np.int32).reshape(-1)
    if lens.shape != (B,) or (lens < 0).any() or (lens > P).any():
        raise ValueError(f"lengths: ({B},) values in [0, {P}] are needed")
    # the stage-1 kernels take whole 4 KiB tiles per lane
    width = -(-P // SCAN_TILE) * SCAN_TILE
    rows = parts if width == P else torch.nn.functional.pad(
        parts, (0, width - P))
    rows = rows.contiguous().view(-1)
    ix = DevicePartIndexer.for_geometry(cfg, width, B, dev)
    entry = ix.submit(list(range(B)), rows, lens,
                      host_rows=rows.numpy() if dev.type == "cpu" else None)
    ends = np.repeat(lens[:, None], C, axis=1)
    sizes = np.zeros((B, C), np.int32)
    hashes = np.zeros((B, C), np.uint64)
    for b, sz, h in ix.retire(ix.plan_hash(entry)):
        n = len(sz)
        ends[b, :n] = np.cumsum(sz, dtype=np.int64)
        sizes[b, :n] = sz
        hashes[b, :n] = h
    hashes = hashes.reshape(-1)
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (hashes >> np.uint64(32)).astype(np.int64)
    return tuple(torch.from_numpy(x).to(dev) for x in (ends, sizes, lo, hi))
