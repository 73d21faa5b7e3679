"""Folder indexing with the chunk+hash data plane on a torch device.

Port of the device dispatch of ``longtail_tpu/core/indexing.py``
(``_chunk_assets_device``, ``chunk_assets``, ``create_version_index``):
``device`` takes the place of ``xp=jnp``.  Folder scan, the host chunker
for small files, the chunk-stream assembly and the version-index build
are the host package's, through ``_host``.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from longtail_tpu_torch import _host
from longtail_tpu_torch.parallel.pipeline import (
    DevicePartIndexer,
    resolve_device,
)

C = _host.constants
FileInfos = _host.host_indexing.FileInfos
get_files_recursively = _host.host_indexing.get_files_recursively

# the hashes the device data plane runs, by hash identifier
DEVICE_HASH_KINDS = {C.HASH_TYPE_BLAKE3: "blake3",
                     C.HASH_TYPE_BLAKE2: "blake2"}


def _chunk_assets_device(storage, root: str, file_infos: FileInfos,
                         target_chunk_size: int, hash_identifier: int,
                         device: torch.device, progress=_host.null_progress,
                         workers: int = 8) -> list:
    """Stream large files' parts through the device pipeline while small
    files run on the host path concurrently (a small file would
    waste a whole lane), both with the hash ``hash_identifier``.  Returns
    per-asset (hashes u64, sizes u32)."""
    hi = _host.host_indexing
    indexer = DevicePartIndexer(target_chunk_size, device,
                                hash_kind=DEVICE_HASH_KINDS[hash_identifier])
    max_part = indexer.part_bytes
    small_cutoff = max(indexer.cfg.max_size, max_part // 64)
    count = file_infos.count
    results = [
        (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32))
        for _ in range(count)
    ]
    big = [i for i in range(count)
           if int(file_infos.sizes[i]) > small_cutoff]
    small = [i for i in range(count)
             if 0 < int(file_infos.sizes[i]) <= small_cutoff]

    done = 0
    done_lock = threading.Lock()

    def tick():
        nonlocal done
        with done_lock:
            done += 1
            progress(min(done, count), count)

    hasher = _host.get_hasher(hash_identifier)

    def small_work(i: int):
        results[i] = hi._chunk_one_asset(
            storage, root, file_infos.paths[i], int(file_infos.sizes[i]),
            target_chunk_size, hasher, np)
        tick()

    def parts():
        for i in big:
            size = int(file_infos.sizes[i])
            path = file_infos.paths[i]
            full = f"{root}/{path}" if root else path
            read = hi._part_reader(storage, full, size)
            pos = 0
            while pos < size:
                n = min(max_part, size - pos)
                yield i, read(pos, n)
                pos += n

    with ThreadPoolExecutor(max_workers=max(1, workers // 2)) as pool:
        futures = [pool.submit(small_work, i) for i in small]
        acc: dict[int, list] = {}
        for i, sizes, hashes in indexer.index_stream(parts()):
            acc.setdefault(i, []).append((hashes, sizes))
            tick()
        for i, pieces in acc.items():
            results[i] = (np.concatenate([p[0] for p in pieces]),
                          np.concatenate([p[1] for p in pieces]))
        for f in futures:
            f.result()
    return results


def chunk_assets(storage, root: str, file_infos: FileInfos,
                 hash_identifier: int, target_chunk_size: int,
                 asset_tags: np.ndarray | None = None,
                 workers: int | None = None, device=None,
                 progress=_host.null_progress):
    """Chunk and hash every asset.  device=None runs the host path;
    otherwise the data plane runs on ``device`` (BLAKE3 or BLAKE2)."""
    if device is None:
        return _host.host_indexing.chunk_assets(
            storage, root, file_infos, hash_identifier, target_chunk_size,
            asset_tags, workers, xp=np, progress=progress)
    device = resolve_device(device)
    if hash_identifier not in DEVICE_HASH_KINDS:
        raise NotImplementedError(
            f"hash {hash_identifier:#x} on a device is not ported yet "
            "(only blake3 and blake2 are)")
    hasher = _host.get_hasher(hash_identifier)
    results = _chunk_assets_device(storage, root, file_infos,
                                   target_chunk_size, hash_identifier,
                                   device, progress, workers or 8)
    return _host.host_indexing.assemble_chunked_assets(
        results, file_infos, hasher, asset_tags)


def create_version_index(storage, root: str,
                         file_infos: FileInfos | None = None,
                         hash_identifier: int | None = None,
                         target_chunk_size: int = C.DEFAULT_TARGET_CHUNK_SIZE,
                         asset_tags: np.ndarray | None = None,
                         workers: int | None = None, device=None,
                         path_filter=None,
                         progress=_host.null_progress):
    """Longtail_CreateVersionIndex with the data plane on ``device``."""
    if hash_identifier is None:
        hash_identifier = C.HASH_TYPE_BLAKE3
    if device is not None:
        device = resolve_device(device)
    if file_infos is None:
        file_infos = get_files_recursively(storage, root, path_filter,
                                           workers=workers or 1)
    ca = chunk_assets(storage, root, file_infos, hash_identifier,
                      target_chunk_size, asset_tags, workers, device,
                      progress)
    return _host.host_indexing.build_version_index_from_chunked(
        ca, file_infos, hash_identifier, target_chunk_size)
