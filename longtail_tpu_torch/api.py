"""High-level upsync with the chunk+hash data plane on a torch device.

Port of ``longtail_tpu/api.py`` ``upsync`` (the reference CLI's UpSync,
cmd/main.c:940).  Dedup and block writing are the host package's; the
block store decides where blocks are compressed (the port's
``stores/compressblockstore.py`` runs its codecs' match search on its
own device).  ``downsync`` and ``validate_version`` are not ported yet
(``_host.host_api`` has them).
"""

from __future__ import annotations

import numpy as np

from longtail_tpu_torch import _host
from longtail_tpu_torch.core.indexing import (
    create_version_index,
    get_files_recursively,
)
from longtail_tpu_torch.parallel.pipeline import resolve_device

C = _host.constants


def upsync(source_storage, source_root: str, block_store,
           target_chunk_size: int = C.DEFAULT_TARGET_CHUNK_SIZE,
           target_block_size: int = C.DEFAULT_TARGET_BLOCK_SIZE,
           max_chunks_per_block: int = C.DEFAULT_MAX_CHUNKS_PER_BLOCK,
           min_block_usage_percent: int = 0,
           hash_identifier: int = C.HASH_TYPE_BLAKE3,
           compression_tag: int = C.COMPRESSION_TYPE_LZ4_DEFAULT,
           workers: int = 8, path_filter=None, device=None,
           progress=_host.null_progress):
    """Index a folder and upload its missing blocks.

    ``device``: where the chunk+hash data plane runs (a CUDA device, or
    "cpu" for the kernels' plain versions); None runs the host path.

    Returns (version_index, version_store_index): the manifest plus a store
    index covering exactly this version's chunks (existing + newly written).
    """
    if device is not None:
        device = resolve_device(device)
    file_infos = get_files_recursively(source_storage, source_root,
                                       path_filter, workers=workers)
    asset_tags = np.full(file_infos.count, compression_tag, dtype=np.uint32)
    with _host.memtracer.context("ChunkAssets"):
        version_index = create_version_index(
            source_storage, source_root, file_infos, hash_identifier,
            target_chunk_size, asset_tags=asset_tags, workers=workers,
            device=device, progress=progress)

    existing = block_store.get_existing_content(
        version_index.chunk_hashes, min_block_usage_percent)
    missing = _host.create_missing_content(
        existing, version_index, target_block_size, max_chunks_per_block)
    with _host.memtracer.context("WriteContent"):
        _host.write_content(source_storage, block_store, missing,
                            version_index, source_root, workers=workers,
                            progress=progress)
    block_store.flush()
    version_store_index = _host.store_algebra.merge_store_index(
        missing, existing)
    return version_index, version_store_index
