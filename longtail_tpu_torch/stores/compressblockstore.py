"""Compression wrapper store
(lib/compressblockstore/longtail_compressblockstore.c) — the port's copy
of ``longtail_tpu/stores/compressblockstore.py``, whose codecs run their
match search on ``device``: None for the host codecs, or a torch device.

Put: when the block tag names a codec, the chunk payload is replaced by
``[u32 raw_size][u32 compressed_size][compressed payload]`` (:118-139); tag 0
passes through raw (:86-93).  Get: decompress when the stored block's tag is a
registered codec.  The block index (chunk hashes + RAW chunk sizes) is
unchanged, so indices always describe uncompressed content.
"""

from __future__ import annotations

import struct

import numpy as np

from longtail_tpu_torch.formats.store_index import StoredBlock
from longtail_tpu_torch.ops.compression_registry import (
    get_codec,
    supported_tags,
)
from longtail_tpu_torch.stores.blockstore import BlockStoreBase
from longtail_tpu_torch.utils.device import resolve_device
from longtail_tpu_torch.utils.monitor import span

_HDR = struct.Struct("<II")


def compress_block(stored_block: StoredBlock, device=None) -> StoredBlock:
    tag = stored_block.block_index.tag
    if tag == 0:
        return stored_block
    codec = get_codec(tag, device)
    raw = stored_block.block_data
    comp = codec.compress(tag, raw)
    with span("codec.frame", len(raw)):
        data = _HDR.pack(len(raw), len(comp)) + comp
    return StoredBlock(block_index=stored_block.block_index, block_data=data)


def decompress_block(stored_block: StoredBlock,
                     as_array: bool = False) -> StoredBlock:
    """as_array=True returns the raw payload as a uint8 ndarray decoded
    with the codec's _into entry — no header-slice copy, no memset, no
    copy-out (three full-block passes saved on the downsync hot loop,
    reference hot loop longtail_compressblockstore.c:150-176).  Callers
    on that path (core/change.py) only take memoryview range slices."""
    tag = stored_block.block_index.tag
    if tag == 0 or tag not in supported_tags():
        return stored_block
    raw_size, comp_size = _HDR.unpack_from(stored_block.block_data, 0)
    codec = get_codec(tag)
    into = getattr(codec, "decompress_into", None) if as_array else None
    payload = memoryview(stored_block.block_data)[
        _HDR.size:_HDR.size + comp_size]
    if into is not None:
        raw = np.empty(raw_size, np.uint8)
        into(tag, payload, raw)
    else:
        raw = codec.decompress(tag, bytes(payload), raw_size)
    return StoredBlock(block_index=stored_block.block_index, block_data=raw)


class CompressBlockStore(BlockStoreBase):
    def __init__(self, backing, device=None):
        super().__init__()
        self.backing = backing
        self.device = None if device is None else resolve_device(device)

    def put_stored_block(self, stored_block: StoredBlock) -> None:
        self.stats.bump("put_stored_block_count")
        self.backing.put_stored_block(compress_block(stored_block,
                                                     self.device))

    def get_stored_block(self, block_hash: int) -> StoredBlock:
        self.stats.bump("get_stored_block_count")
        return decompress_block(self.backing.get_stored_block(block_hash))

    def get_stored_block_raw(self, block_hash: int) -> StoredBlock:
        """Fetch without decoding — the I/O half of the downsync job
        graph's fetch->decompress split."""
        self.stats.bump("get_stored_block_count")
        return self.backing.get_stored_block(block_hash)

    def decompress_stored_block(self, stored_block: StoredBlock) -> StoredBlock:
        # downsync job-graph path: ndarray payload, zero extra copies
        return decompress_block(stored_block, as_array=True)

    def preflight_get(self, block_hashes) -> None:
        self.backing.preflight_get(block_hashes)

    def get_existing_content(self, chunk_hashes: np.ndarray,
                             min_block_usage_percent: int = 0):
        self.stats.bump("get_existing_content_count")
        return self.backing.get_existing_content(
            chunk_hashes, min_block_usage_percent)

    def prune_blocks(self, keep_block_hashes) -> int:
        return self.backing.prune_blocks(keep_block_hashes)

    def reload_index(self) -> None:
        f = getattr(self.backing, "reload_index", None)
        if f is not None:
            f()

    def flush(self) -> None:
        self.backing.flush()
        self.stats.bump("flush_count")
