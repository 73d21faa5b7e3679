"""Chunking geometry of the device data plane.

Only ``ChunkerConfig`` of ``longtail_tpu/parallel/device_chunker.py`` is
ported: the rest of that module is the earlier XLA chunker, which stage 1
(``parallel/stage1.py``) supersedes.
"""

from __future__ import annotations

import dataclasses

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

    @property
    def padded_chunk(self) -> int:
        return -(-self.max_size // _LEAF) * _LEAF
