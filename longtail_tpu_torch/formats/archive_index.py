"""ArchiveIndex: header of a single-file archive (.la)
(struct Longtail_ArchiveIndex src/longtail.h:1883-1891,
Longtail_CreateArchiveIndex src/longtail.c:9921,
Longtail_ReadArchiveIndex :10002).

Layout (little-endian)::

    u32 version            (0.0.1)
    u32 index_data_size    (total header size, 8-byte aligned)
    ...store index data... (StoreIndex blob)
    u64 block_start_offsets[block_count]   (relative to payload area)
    u32 block_sizes[block_count]           (serialized StoredBlock sizes)
    ...version index data... (VersionIndex blob)
    <zero pad to 8-byte alignment>
    <block payloads>
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from longtail_tpu_torch.formats.constants import CURRENT_ARCHIVE_VERSION
from longtail_tpu_torch.formats.store_index import StoreIndex
from longtail_tpu_torch.formats.version_index import FormatError, VersionIndex

_HEAD = struct.Struct("<II")


@dataclasses.dataclass
class ArchiveIndex:
    store_index: StoreIndex
    version_index: VersionIndex
    block_start_offsets: np.ndarray  # u64[block_count]
    block_sizes: np.ndarray          # u32[block_count]
    version: int = CURRENT_ARCHIVE_VERSION

    @property
    def index_data_size(self) -> int:
        raw = (_HEAD.size + len(self.store_index.to_bytes())
               + 12 * self.store_index.block_count
               + len(self.version_index.to_bytes()))
        return (raw + 7) & ~7

    def to_bytes(self) -> bytes:
        si = self.store_index.to_bytes()
        vi = self.version_index.to_bytes()
        out = bytearray()
        out += _HEAD.pack(self.version, 0)  # size patched below
        out += si
        out += np.ascontiguousarray(self.block_start_offsets,
                                    dtype="<u8").tobytes()
        out += np.ascontiguousarray(self.block_sizes, dtype="<u4").tobytes()
        out += vi
        while len(out) % 8:
            out.append(0)
        struct.pack_into("<I", out, 4, len(out))
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ArchiveIndex":
        if len(data) < _HEAD.size:
            raise FormatError("archive index too small")
        version, index_size = _HEAD.unpack_from(data, 0)
        if version != CURRENT_ARCHIVE_VERSION:
            raise FormatError(f"unsupported archive version {version:#x}")
        off = _HEAD.size
        store_index = StoreIndex.from_bytes(data[off:])
        si_size = len(store_index.to_bytes())
        off += si_size
        bc = store_index.block_count
        block_start_offsets = np.frombuffer(data, dtype="<u8", count=bc,
                                            offset=off)
        off += 8 * bc
        block_sizes = np.frombuffer(data, dtype="<u4", count=bc, offset=off)
        off += 4 * bc
        version_index = VersionIndex.from_bytes(data[off:index_size])
        return cls(store_index=store_index, version_index=version_index,
                   block_start_offsets=block_start_offsets,
                   block_sizes=block_sizes, version=version)

    @classmethod
    def create(cls, store_index: StoreIndex,
               version_index: VersionIndex) -> "ArchiveIndex":
        bc = store_index.block_count
        return cls(store_index=store_index, version_index=version_index,
                   block_start_offsets=np.zeros(bc, dtype="<u8"),
                   block_sizes=np.zeros(bc, dtype="<u4"))
