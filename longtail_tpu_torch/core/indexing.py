"""Folder scan + chunking driver + version-index construction, with the
chunk+hash data plane on a torch device.

The port of ``longtail_tpu/core/indexing.py``.  Mirrors the semantics of
the reference pipeline (``Longtail_GetFilesRecursively2``
src/longtail.c:1656, ``ChunkAssets`` :2343, ``Longtail_CreateVersionIndex``
:2808) with a batched execution model:

- every file is split into independent parts of ``target_chunk_size * 1024``
  bytes (src/longtail.c:2396-2404), each part chunked with HPCDC bounds
  (min, avg, max) = (target/8, target/2, target*2) clamped to the 48-byte
  window (:1985-1987);
- chunk payloads are hashed in bulk (native batch hasher, or lanes of
  padded chunks) instead of one HashBuffer call per chunk;
- per-asset content hash = hash of the asset's chunk-hash array bytes
  (:2518-2537); asset path hash = hash of the utf-8 path (:1269-1279).

``device`` takes the place of the JAX package's ``xp=jnp``: the CUDA card
by default (raising where there is none), "cpu" for the kernels' plain
versions, None for the host path (native chunker and hasher, the JAX
package's ``xp=np``).  The device data plane runs BLAKE3 and BLAKE2;
meow runs on the host path on any device, as in the JAX package.
``mesh`` (a sequence of torch devices or their names, in place of a
``jax.sharding.Mesh``) deals the BLAKE3 data plane over one indexer per
device (``parallel/pipeline.py`` ``MeshPartIndexer``).
"""

from __future__ import annotations

import dataclasses
import errno
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from longtail_tpu_torch.formats.constants import (
    CHUNKER_WINDOW_SIZE,
    DEFAULT_TARGET_CHUNK_SIZE,
    HASH_TYPE_BLAKE2,
    HASH_TYPE_BLAKE3,
    chunker_params_from_target,
)
from longtail_tpu_torch.formats.version_index import VersionIndex
from longtail_tpu_torch.ops import cdc
from longtail_tpu_torch.ops.hash_registry import get_hasher
from longtail_tpu_torch.parallel.pipeline import (
    DevicePartIndexer,
    MeshPartIndexer,
)
from longtail_tpu_torch.stores.storage import Storage, walk_files
from longtail_tpu_torch.utils.device import resolve_device
from longtail_tpu_torch.utils.monitor import carry, now_ns, record, span
from longtail_tpu_torch.utils.progress import null_progress

# the hashes the device data plane runs, by hash identifier
DEVICE_HASH_KINDS = {HASH_TYPE_BLAKE3: "blake3",
                     HASH_TYPE_BLAKE2: "blake2"}


@dataclasses.dataclass
class FileInfos:
    """Scan result (Longtail_FileInfos, src/longtail.h:1684-1692).
    Directory entries end with '/' and have size 0."""
    paths: list[str]
    sizes: np.ndarray        # u64
    permissions: np.ndarray  # u16

    @property
    def count(self) -> int:
        return len(self.paths)

    @classmethod
    def from_entries(cls, entries: list[tuple[str, int, int]]) -> "FileInfos":
        return cls(
            paths=[e[0] for e in entries],
            sizes=np.array([e[1] for e in entries], dtype=np.uint64),
            permissions=np.array([e[2] for e in entries], dtype=np.uint16),
        )


def get_files_recursively(storage: Storage, root: str, path_filter=None,
                          workers: int = 1) -> FileInfos:
    """Longtail_GetFilesRecursively2 (src/longtail.c:1656): parallel
    per-directory scan jobs when workers > 1; same deterministic order."""
    if workers > 1:
        from longtail_tpu_torch.stores.storage import walk_files_parallel
        return FileInfos.from_entries(
            walk_files_parallel(storage, root, path_filter, workers))
    return FileInfos.from_entries(list(walk_files(storage, root, path_filter)))


# ---------------------------------------------------------------------------
# bulk chunk hashing: bucket variable-length chunks into padded lane batches
# ---------------------------------------------------------------------------

_LEAF = 1024


def hash_chunk_batch(hasher, part_data: np.ndarray,
                     offsets: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Hash chunks [offsets[i], offsets[i]+sizes[i]) of part_data.

    Buckets chunks by padded length (next multiple of 1 KiB) so each bucket is
    a static-shape (lanes, padded) batch, after the native path
    (``hash_ranges``) where the hasher has one and it is built.
    """
    n = len(sizes)
    out = np.zeros(n, dtype=np.uint64)
    if n == 0:
        return out
    sizes = np.asarray(sizes, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    ranged = getattr(hasher, "hash_ranges", None)
    if ranged is not None:
        res = ranged(part_data, offsets, sizes)
        if res is not None:
            return res
    padded = np.maximum((sizes + _LEAF - 1) // _LEAF, 1) * _LEAF
    # round padded up to the next power-of-two leaf count to bound bucket count
    leaves = padded // _LEAF
    pow2 = np.uint64(1) << np.uint64(np.ceil(np.log2(
        np.maximum(leaves, 1))).astype(np.uint64))
    padded = (pow2 * _LEAF).astype(np.int64)
    for cls_size in np.unique(padded):
        idx = np.flatnonzero(padded == cls_size)
        batch = np.zeros((len(idx), int(cls_size)), dtype=np.uint8)
        for row, i in enumerate(idx):
            o, s = offsets[i], sizes[i]
            batch[row, :s] = part_data[o:o + s]
        out[idx] = np.asarray(hasher.hash_chunks(batch, sizes[idx]))
    return out


# ---------------------------------------------------------------------------
# chunking driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkedAssets:
    """Per-asset chunk streams, pre-dedup (ChunkAssetsData analog)."""
    chunk_hashes: np.ndarray   # u64[total]
    chunk_sizes: np.ndarray    # u32[total]
    chunk_tags: np.ndarray     # u32[total]
    asset_chunk_counts: np.ndarray  # u32[asset_count]
    asset_chunk_start_index: np.ndarray  # u32[asset_count]
    path_hashes: np.ndarray    # u64[asset_count]
    content_hashes: np.ndarray  # u64[asset_count]


def _part_reader(storage, full_path: str, size: int):
    """Returns read(pos, n) -> uint8 view of n bytes of the file at pos.

    Files over 1 MiB go through map_file (zero-copy, the reference's mmap
    chunking path src/longtail.c:2130-2216); small files use plain reads
    so thousands of tiny assets don't pin thousands of mappings.  The
    returned arrays keep the mapping alive via their buffer reference.

    A read or a mapped view that holds fewer than n bytes (the file
    shrank after it was listed) raises StorageError naming the path, the
    offset and the bytes wanted and got: an index of the bytes it did get
    would record asset sizes that its chunk sizes do not sum to."""
    from longtail_tpu_torch.stores.storage import StorageError, map_or_read

    def checked(pos: int, n: int, buf) -> np.ndarray:
        if len(buf) != n:
            raise StorageError(
                errno.EIO, f"short read at offset {pos}: wanted {n} bytes, "
                f"got {len(buf)}", full_path)
        return np.frombuffer(buf, dtype=np.uint8)

    if size >= (1 << 20):
        try:
            mf = map_or_read(storage, full_path)
            return lambda pos, n: checked(pos, n, mf.view[pos:pos + n])
        except Exception:
            pass
    return lambda pos, n: checked(pos, n, storage.read(full_path, pos, n))


def _asset_parts(storage, root: str, path: str, size: int,
                 part_bytes: int):
    """Yield the bytes of each part of ``part_bytes`` (the last one
    shorter) of an asset, in order, read through ``_part_reader``."""
    full_path = f"{root}/{path}" if root else path
    read = _part_reader(storage, full_path, size)
    for pos in range(0, size, part_bytes):
        yield read(pos, min(part_bytes, size - pos))


def _chunk_one_asset(storage, root: str, path: str, size: int,
                     target_chunk_size: int, hasher):
    """Chunk + hash a single asset, part by part. Returns (hashes, sizes)."""
    min_s, avg_s, max_s = chunker_params_from_target(target_chunk_size)
    all_hashes = []
    all_sizes = []
    for data in _asset_parts(storage, root, path, size,
                             target_chunk_size * 1024):
        part_size = len(data)
        if part_size <= CHUNKER_WINDOW_SIZE:
            # whole part is one chunk (DynamicChunking small-part path,
            # src/longtail.c:2053-2115)
            ends = np.array([part_size], dtype=np.int64)
        else:
            ends = cdc.chunk_part(data, min_s, avg_s, max_s)
        starts = np.concatenate([[0], ends[:-1]])
        sizes = (ends - starts).astype(np.int64)
        hashes = hash_chunk_batch(hasher, data, starts, sizes)
        all_hashes.append(hashes)
        all_sizes.append(sizes.astype(np.uint32))
    if not all_hashes:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32))
    return (np.concatenate(all_hashes), np.concatenate(all_sizes))


def _chunk_assets_card(storage, root: str, file_infos: FileInfos,
                       target_chunk_size: int, hasher, indexer,
                       small_cutoff: int, progress=null_progress,
                       workers: int = 8) -> list:
    """Stream the parts of every file over ``small_cutoff`` bytes through
    ``indexer`` (a DevicePartIndexer or a MeshPartIndexer) while the
    smaller ones run on the host path on ``max(1, workers // 2)`` threads
    (a small file would waste a whole lane).  Parts are tagged by asset
    and retire in submission order; global dedup is the host unique of
    create_version_index, as in ``longtail_tpu/core/indexing.py:253``.
    Returns per-asset (hashes u64, sizes u32)."""
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

    def small_work(i: int):
        results[i] = _chunk_one_asset(
            storage, root, file_infos.paths[i], int(file_infos.sizes[i]),
            target_chunk_size, hasher)
        tick()

    def parts():
        for i in big:
            for data in _asset_parts(storage, root, file_infos.paths[i],
                                     int(file_infos.sizes[i]),
                                     indexer.part_bytes):
                yield i, data

    with ThreadPoolExecutor(max_workers=max(1, workers // 2)) as pool:
        futures = [pool.submit(carry(small_work), i) for i in small]
        acc: dict[int, list] = {}
        for i, sizes, hashes in indexer.index_stream(parts()):
            acc.setdefault(i, []).append((hashes, sizes))
            tick()
        for i, pieces in acc.items():
            results[i] = (np.concatenate([p[0] for p in pieces]),
                          np.concatenate([p[1] for p in pieces]))
        with span("index.small_wait"):
            for f in futures:
                f.result()
    return results


def chunk_assets(storage: Storage, root: str, file_infos: FileInfos,
                 hash_identifier: int, target_chunk_size: int,
                 asset_tags: np.ndarray | None = None,
                 workers: int | None = None, device="cuda",
                 mesh=None, progress=null_progress) -> ChunkedAssets:
    """Chunk and hash every asset: over the devices of ``mesh`` (BLAKE3
    only, as in the JAX package), else on ``device`` (the card by
    default, "cpu" for the plain versions), or on the host path with
    None."""
    hasher = get_hasher(hash_identifier)
    count = file_infos.count
    if device is not None:
        device = resolve_device(device)
    indexer = None
    if mesh is not None and hash_identifier == HASH_TYPE_BLAKE3:
        # every file goes through the cards, small ones too
        indexer = MeshPartIndexer(target_chunk_size, mesh)
        small_cutoff = 0
    # the JAX package has no device meow (its hasher ignores xp), so meow
    # runs on the host path whatever the device: there is no kernel to run
    elif device is not None and hash_identifier in DEVICE_HASH_KINDS:
        indexer = DevicePartIndexer(
            target_chunk_size, device,
            hash_kind=DEVICE_HASH_KINDS[hash_identifier])
        small_cutoff = max(indexer.cfg.max_size, indexer.part_bytes // 64)
    if indexer is not None:
        results = _chunk_assets_card(storage, root, file_infos,
                                     target_chunk_size, hasher, indexer,
                                     small_cutoff, progress, workers or 8)
        return assemble_chunked_assets(results, file_infos, hasher,
                                       asset_tags)

    results = [None] * count

    def work(i: int):
        results[i] = _chunk_one_asset(
            storage, root, file_infos.paths[i], int(file_infos.sizes[i]),
            target_chunk_size, hasher)
        progress(i + 1, count)

    if workers and workers > 1 and count > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(work, range(count)))
    else:
        for i in range(count):
            work(i)
    return assemble_chunked_assets(results, file_infos, hasher, asset_tags)


def hash_assets(hasher, paths: list[str], chunk_hashes: np.ndarray,
                starts: np.ndarray, counts: np.ndarray):
    """(path_hashes, content_hashes) of every asset: the hash of its
    utf-8 path (src/longtail.c:1269-1279) and of its chunk-hash bytes
    (:2531).  One native ``hash_ranges`` call each, over the path blob of
    ``build_name_data`` and the chunk-hash array's bytes, where the hasher
    has one and it is built (recorded as ``index.asset_hash.batch``);
    else one ``hash_buffer`` call per path and per asset."""
    count = len(paths)
    ranged = getattr(hasher, "hash_ranges", None)
    if count and ranged is not None:
        t0 = now_ns()
        offsets, blob = build_name_data(paths)
        sizes = np.diff(offsets.astype(np.int64), append=len(blob)) - 1
        path_hashes = ranged(np.frombuffer(blob, dtype=np.uint8), offsets,
                             sizes)
        if path_hashes is not None:
            data = np.ascontiguousarray(chunk_hashes, dtype="<u8")
            content_hashes = ranged(data.view(np.uint8),
                                    starts.astype(np.int64) * 8,
                                    counts.astype(np.int64) * 8)
            if content_hashes is not None:
                record("index.asset_hash.batch", t0, now_ns(), count)
                return path_hashes, content_hashes
    path_hashes = np.array([hasher.hash_buffer(p.encode("utf-8"))
                            for p in paths], dtype=np.uint64)
    content_hashes = np.array([
        hasher.hash_buffer(chunk_hashes[starts[i]:starts[i] + counts[i]]
                           .astype("<u8").tobytes())
        for i in range(count)], dtype=np.uint64)
    return path_hashes, content_hashes


def assemble_chunked_assets(results, file_infos: FileInfos, hasher,
                            asset_tags=None) -> ChunkedAssets:
    """Fold per-asset (hashes, sizes) streams into ChunkedAssets, with
    each asset's path and content hash (``hash_assets``).  Also the
    reassembly step after the multi-host chunk-result exchange."""
    count = file_infos.count
    counts = np.array([len(r[0]) for r in results], dtype=np.uint32)
    starts = np.zeros(count, dtype=np.uint32)
    if count:
        np.cumsum(counts[:-1], out=starts[1:])
    total = int(counts.sum())
    chunk_hashes = np.concatenate([r[0] for r in results]) if count \
        else np.zeros(0, dtype=np.uint64)
    chunk_sizes = np.concatenate([r[1] for r in results]) if count \
        else np.zeros(0, dtype=np.uint32)
    if asset_tags is not None:
        chunk_tags = np.repeat(np.asarray(asset_tags, dtype=np.uint32), counts)
    else:
        chunk_tags = np.zeros(total, dtype=np.uint32)

    with span("index.asset_hash", count):
        path_hashes, content_hashes = hash_assets(
            hasher, file_infos.paths, chunk_hashes, starts, counts)

    return ChunkedAssets(
        chunk_hashes=chunk_hashes, chunk_sizes=chunk_sizes,
        chunk_tags=chunk_tags, asset_chunk_counts=counts,
        asset_chunk_start_index=starts, path_hashes=path_hashes,
        content_hashes=content_hashes)


def build_name_data(paths: list[str]) -> tuple[np.ndarray, bytes]:
    offsets = np.zeros(len(paths), dtype=np.uint32)
    blob = bytearray()
    for i, p in enumerate(paths):
        offsets[i] = len(blob)
        blob += p.encode("utf-8") + b"\0"
    return offsets, bytes(blob)


def create_version_index(storage: Storage, root: str,
                         file_infos: FileInfos | None = None,
                         hash_identifier: int | None = None,
                         target_chunk_size: int = DEFAULT_TARGET_CHUNK_SIZE,
                         asset_tags: np.ndarray | None = None,
                         workers: int | None = None, device="cuda",
                         mesh=None, path_filter=None,
                         progress=null_progress) -> VersionIndex:
    """Longtail_CreateVersionIndex (src/longtail.c:2808) with the data
    plane on ``device`` or over ``mesh`` (see ``chunk_assets``)."""
    if hash_identifier is None:
        hash_identifier = HASH_TYPE_BLAKE3
    if device is not None:
        device = resolve_device(device)
    with span("index") as s:
        if file_infos is None:
            file_infos = get_files_recursively(storage, root, path_filter,
                                               workers=workers or 1)
        s.n = int(file_infos.sizes.sum())
        ca = chunk_assets(storage, root, file_infos, hash_identifier,
                          target_chunk_size, asset_tags, workers, device,
                          mesh, progress)
        return build_version_index_from_chunked(
            ca, file_infos, hash_identifier, target_chunk_size)


def build_version_index_from_chunked(ca: ChunkedAssets,
                                     file_infos: FileInfos,
                                     hash_identifier: int,
                                     target_chunk_size: int) -> VersionIndex:
    """Longtail_BuildVersionIndex (src/longtail.c:2709): assemble the
    zero-parse index from already-chunked per-asset streams.  Separate
    from create_version_index so the multi-host driver can feed it the
    globally exchanged chunk results (parallel/multihost.py)."""
    # dedup chunks preserving first-occurrence order (src/longtail.c:2949-2972)
    uniq_hashes, first_idx, inverse = np.unique(
        ca.chunk_hashes, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    # remap so unique chunks appear in first-occurrence order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    asset_chunk_indexes = rank[inverse].astype(np.uint32)
    chunk_hashes = uniq_hashes[order]
    chunk_sizes = ca.chunk_sizes[first_idx[order]] if len(order) \
        else np.zeros(0, dtype=np.uint32)
    chunk_tags = ca.chunk_tags[first_idx[order]] if len(order) \
        else np.zeros(0, dtype=np.uint32)

    name_offsets, name_data = build_name_data(file_infos.paths)

    return VersionIndex(
        hash_identifier=hash_identifier,
        target_chunk_size=target_chunk_size,
        path_hashes=ca.path_hashes,
        content_hashes=ca.content_hashes,
        asset_sizes=file_infos.sizes.astype("<u8"),
        asset_chunk_counts=ca.asset_chunk_counts,
        asset_chunk_index_starts=ca.asset_chunk_start_index,
        asset_chunk_indexes=asset_chunk_indexes,
        chunk_hashes=chunk_hashes.astype("<u8"),
        chunk_sizes=chunk_sizes.astype("<u4"),
        chunk_tags=chunk_tags.astype("<u4"),
        name_offsets=name_offsets,
        permissions=file_infos.permissions.astype("<u2"),
        name_data=name_data,
    )
