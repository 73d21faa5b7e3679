"""BlockStore seam: content-addressed block storage
(Longtail_BlockStoreAPI, src/longtail.h:789-799).

The reference API is callback-async; our runtime exposes synchronous methods
(plus ``flush``) and layers concurrency with executors at the call sites —
device-side parallelism comes from batched kernels, host-side overlap from
thread pools in the write/read drivers.

Stats mirror Longtail_BlockStore_Stats (src/longtail.h:743-774).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Protocol

import numpy as np

from longtail_tpu_torch.formats.store_index import StoreIndex, StoredBlock


@dataclasses.dataclass
class BlockStoreStats:
    get_stored_block_count: int = 0
    get_stored_block_byte_count: int = 0
    get_stored_block_fail_count: int = 0
    put_stored_block_count: int = 0
    put_stored_block_byte_count: int = 0
    put_stored_block_fail_count: int = 0
    get_existing_content_count: int = 0
    preflight_count: int = 0
    flush_count: int = 0
    chunks_in_get_count: int = 0
    chunks_in_put_count: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)


class BlockStore(Protocol):
    def put_stored_block(self, stored_block: StoredBlock) -> None: ...
    def get_stored_block(self, block_hash: int) -> StoredBlock: ...
    def preflight_get(self, block_hashes: np.ndarray) -> None: ...
    def get_existing_content(self, chunk_hashes: np.ndarray,
                             min_block_usage_percent: int = 0) -> StoreIndex: ...
    def prune_blocks(self, keep_block_hashes: np.ndarray) -> int: ...
    def get_stats(self) -> BlockStoreStats: ...
    def flush(self) -> None: ...


class BlockStoreBase:
    """Default no-op surfaces shared by store implementations/wrappers."""

    def __init__(self):
        self.stats = BlockStoreStats()

    def preflight_get(self, block_hashes) -> None:
        self.stats.bump("preflight_count")

    # split fetch/decode seam: the downsync job graph fetches raw blocks
    # on its I/O channel and decodes on the compute channel
    # (WriteContentBlock2Job's async GetStoredBlock + decompress split,
    # src/longtail.c:8347 + longtail_compressblockstore.c:132).  Stores
    # without a codec layer decode as identity.
    def get_stored_block_raw(self, block_hash: int):
        return self.get_stored_block(block_hash)

    def decompress_stored_block(self, stored_block):
        return stored_block

    def get_stats(self) -> BlockStoreStats:
        return self.stats

    def flush(self) -> None:
        self.stats.bump("flush_count")

    def prune_blocks(self, keep_block_hashes) -> int:
        raise NotImplementedError
