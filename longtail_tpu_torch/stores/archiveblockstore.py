"""Single-file archive block store + pack/unpack pipelines
(lib/archiveblockstore/longtail_archiveblockstore.c; CLI Pack cmd/main.c:2116,
Unpack :2396).

Write mode: every put reserves the next offset in the payload area (the
reference does this under a spinlock, :60-80) and records offset+size in the
ArchiveIndex, which is written at file start on close.  Read mode: blocks are
served with ranged reads at ``index_data_size + offset``.
"""

from __future__ import annotations

import threading

import numpy as np

from longtail_tpu_torch.core.dedup import create_missing_content, \
    get_existing_store_index
from longtail_tpu_torch.formats.archive_index import ArchiveIndex
from longtail_tpu_torch.formats.store_index import StoreIndex, StoredBlock
from longtail_tpu_torch.stores.blockstore import BlockStoreBase
from longtail_tpu_torch.stores.compressblockstore import CompressBlockStore
from longtail_tpu_torch.stores.storage import Storage, ensure_parent_dirs
from longtail_tpu_torch.utils.device import resolve_device
from longtail_tpu_torch.utils.progress import null_progress


class ArchiveBlockStoreWriter(BlockStoreBase):
    def __init__(self, storage: Storage, path: str,
                 archive_index: ArchiveIndex):
        super().__init__()
        self.storage = storage
        self.path = path
        self.archive = archive_index
        self._lock = threading.Lock()
        self._next_offset = 0
        self._block_pos = {int(h): i for i, h in
                           enumerate(archive_index.store_index.block_hashes)}
        self._offsets = np.zeros(archive_index.store_index.block_count,
                                 dtype=np.uint64)
        self._sizes = np.zeros(archive_index.store_index.block_count,
                               dtype=np.uint32)
        ensure_parent_dirs(storage, path)
        storage.write(path, b"")  # truncate

    def put_stored_block(self, stored_block: StoredBlock) -> None:
        blob = stored_block.to_bytes()
        b = self._block_pos[stored_block.block_index.block_hash]
        with self._lock:
            offset = self._next_offset
            self._next_offset += len(blob)
            self._offsets[b] = offset
            self._sizes[b] = len(blob)
        self.storage.write(self.path, blob,
                           self.archive.index_data_size + offset)
        self.stats.bump("put_stored_block_count")
        self.stats.bump("put_stored_block_byte_count", len(blob))

    def get_existing_content(self, chunk_hashes, min_block_usage_percent=0):
        return StoreIndex.from_blocks([])

    def get_stored_block(self, block_hash: int) -> StoredBlock:
        raise NotImplementedError("archive writer is write-only")

    def close(self) -> None:
        self.archive.block_start_offsets = self._offsets
        self.archive.block_sizes = self._sizes
        # patch the header without truncating the payload area
        total = self.archive.index_data_size + self._next_offset
        self.storage.write_ranges(self.path, total,
                                  [(0, self.archive.to_bytes())])


class ArchiveBlockStoreReader(BlockStoreBase):
    def __init__(self, storage: Storage, path: str):
        super().__init__()
        self.storage = storage
        self.path = path
        head = storage.read(path, 0, 8)
        import struct
        _, index_size = struct.unpack("<II", head)
        self.archive = ArchiveIndex.from_bytes(storage.read(path, 0, index_size))
        self._block_pos = {int(h): i for i, h in
                           enumerate(self.archive.store_index.block_hashes)}

    def get_stored_block(self, block_hash: int) -> StoredBlock:
        b = self._block_pos[int(block_hash)]
        offset = int(self.archive.block_start_offsets[b])
        size = int(self.archive.block_sizes[b])
        blob = self.storage.read(
            self.path, self.archive.index_data_size + offset, size)
        self.stats.bump("get_stored_block_count")
        self.stats.bump("get_stored_block_byte_count", size)
        return StoredBlock.from_bytes(blob)

    def get_existing_content(self, chunk_hashes, min_block_usage_percent=0):
        self.stats.bump("get_existing_content_count")
        return get_existing_store_index(self.archive.store_index, chunk_hashes,
                                        min_block_usage_percent)

    def put_stored_block(self, stored_block: StoredBlock) -> None:
        raise NotImplementedError("archive reader is read-only")


def pack_archive(storage: Storage, source_root: str, archive_path: str,
                 target_chunk_size: int = 32768,
                 target_block_size: int = 8388608,
                 max_chunks_per_block: int = 1024,
                 hash_identifier: int | None = None,
                 compression_tag: int = 0,
                 workers: int = 8, device="cuda",
                 progress=null_progress) -> tuple[int, int, int]:
    """CLI pack (cmd/main.c:2116): index source, build archive, write every
    block.  Returns (asset_count, block_count, archive_bytes).  The index
    and the block codecs run on ``device``: the card by default, "cpu"
    for the plain versions, None for the host path and codecs."""
    from longtail_tpu_torch.core.indexing import create_version_index, \
        get_files_recursively
    from longtail_tpu_torch.core.write import write_content
    from longtail_tpu_torch.formats.constants import HASH_TYPE_BLAKE3

    if device is not None:
        device = resolve_device(device)
    if hash_identifier is None:
        hash_identifier = HASH_TYPE_BLAKE3
    file_infos = get_files_recursively(storage, source_root)
    asset_tags = np.full(file_infos.count, compression_tag, dtype=np.uint32)
    vi = create_version_index(storage, source_root, file_infos,
                              hash_identifier, target_chunk_size,
                              asset_tags=asset_tags, workers=workers,
                              device=device, progress=progress)
    si = create_missing_content(StoreIndex.from_blocks([]), vi,
                                target_block_size, max_chunks_per_block)
    archive = ArchiveIndex.create(si, vi)
    writer = ArchiveBlockStoreWriter(storage, archive_path, archive)
    store = CompressBlockStore(writer, device=device) \
        if compression_tag else writer
    write_content(storage, store, si, vi, source_root, workers=workers,
                  progress=progress)
    writer.close()
    return vi.asset_count, si.block_count, storage.get_size(archive_path)


def unpack_archive(storage: Storage, archive_path: str, target_root: str,
                   retain_permissions: bool = True, workers: int = 8,
                   device="cuda", progress=null_progress) -> int:
    """CLI unpack (cmd/main.c:2396): read archive, diff against target,
    reconstruct; an existing target is re-indexed on ``device``
    (``api.downsync``)."""
    from longtail_tpu_torch import api

    reader = ArchiveBlockStoreReader(storage, archive_path)
    store = CompressBlockStore(reader)
    api.downsync(store, storage, target_root, reader.archive.version_index,
                 retain_permissions=retain_permissions, workers=workers,
                 min_block_usage_percent=0, device=device,
                 progress=progress)
    return reader.archive.version_index.asset_count
