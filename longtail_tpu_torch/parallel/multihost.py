"""N-process upsync and downsync: per-process file shards and a
chunk-result exchange — the port of ``longtail_tpu/parallel/multihost.py``
on ``torch.distributed`` in place of ``jax.distributed`` and
``multihost_utils``.

Every process scans the same deterministic file list, chunks its own
shard of files on its own device, and the per-asset chunk streams are
exchanged with a padded all-gather over a gloo group, so every process
holds the full chunk results.  From there the missing-content plan is the
same everywhere, so blocks shard by index: each process assembles and
uploads its own slice (block assembly reads source bytes, so the source
tree must be readable from every process), the store index merges under
the ``.lsi`` lock protocol, and process 0 writes the ``.lvi``.

Entry points:

- ``initialize(...)``: ``init_process_group`` over ``tcp://``;
- ``upsync_sharded(...)``: the N-process upsync; with one process it is
  ``api.upsync``;
- ``downsync_sharded(...)``: the N-process reconstruction into one
  shared target;
- ``python -m longtail_tpu_torch.parallel.multihost``: one process of
  the dry run, configured by ``LT_MH_*`` variables (``_dryrun_main``).
"""

from __future__ import annotations

import datetime
import json

import numpy as np
import torch
import torch.distributed as dist

from longtail_tpu_torch.formats import constants as C
from longtail_tpu_torch.utils.progress import null_progress

# the gloo group that carries the host arrays: the default group when it
# is gloo, else one made once per process group (dist.new_group is
# collective, and every process makes it at the same call)
_HOST_GROUP: dict = {}


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Start the default process group over ``tcp://coordinator_address``
    (``host:port``) with ``num_processes`` ranks, this one
    ``process_id``; a process group that is already up is kept.  Its
    backend serves CPU tensors with gloo and, where a card is present,
    CUDA tensors with NCCL (``parallel/distributed.py``'s steps);
    ``exchange_chunk_results`` and ``barrier`` run over gloo."""
    if dist.is_initialized():
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize needs the coordinator address, the "
                         "number of processes and this process's id")
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(minutes=30))


def process_info() -> tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) when no
    process group is up."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _host_group():
    if dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _HOST_GROUP:
        _HOST_GROUP[key] = dist.new_group(backend="gloo")
    return _HOST_GROUP[key]


def shard_assets(file_infos, process_id: int, num_processes: int):
    """Deterministic size-balanced shard: chunkable assets sorted by
    size (descending, index tiebreak) and dealt round-robin."""
    sizes = file_infos.sizes.astype(np.int64)
    # explicit dtype: np.array([]) of an empty comprehension is float64,
    # and bitwise-& with a bool array raises on a dirs-only/empty tree
    is_file = np.fromiter((not p.endswith("/") for p in file_infos.paths),
                          dtype=bool, count=len(file_infos.paths))
    chunked = np.flatnonzero(is_file & (sizes > 0))
    order = chunked[np.lexsort((chunked, -sizes[chunked]))]
    return order[process_id::num_processes]


def _allgather_padded(arr: np.ndarray) -> list:
    """All-gather a variable-length 1-D integer array across processes:
    gather lengths, pad to the longest, gather, return the per-process
    arrays (trimmed) in rank order, in arr's dtype.  The words travel as
    int64: gloo has no unsigned 32- or 64-bit tensors."""
    group = _host_group()
    world = dist.get_world_size()
    n = len(arr)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lens, torch.tensor([n], dtype=torch.int64), group=group)
    lens = [int(x) for x in lens]
    m = max(lens)
    pad = torch.zeros(m, dtype=torch.int64)
    pad[:n] = torch.from_numpy(np.asarray(arr).astype(np.int64))
    out = [torch.empty(m, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(out, pad, group=group)
    return [o[:k].numpy().astype(arr.dtype) for o, k in zip(out, lens)]


def exchange_chunk_results(my_assets, results, count: int):
    """Exchange per-asset (hashes u64, sizes u32) chunk streams so every
    process holds the full ``results`` list for all ``count`` assets.

    ``my_assets``: asset indexes this process chunked; ``results``: the
    full-length list with entries filled only at my_assets.  u64 hashes
    travel as u32 pairs."""
    if process_info()[1] == 1:
        return results
    my_assets = np.asarray(my_assets, dtype=np.int64)
    counts = np.array([len(results[int(a)][0]) for a in my_assets],
                      dtype=np.int64)
    flat_h = np.concatenate(
        [results[int(a)][0] for a in my_assets]) if len(my_assets) \
        else np.zeros(0, np.uint64)
    flat_s = np.concatenate(
        [results[int(a)][1] for a in my_assets]) if len(my_assets) \
        else np.zeros(0, np.uint32)
    lo = (flat_h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (flat_h >> np.uint64(32)).astype(np.uint32)

    g_assets = _allgather_padded(my_assets)
    g_counts = _allgather_padded(counts)
    g_lo = _allgather_padded(lo)
    g_hi = _allgather_padded(hi)
    g_sz = _allgather_padded(flat_s)

    out = [(np.zeros(0, np.uint64), np.zeros(0, np.uint32))
           for _ in range(count)]
    for p in range(len(g_assets)):
        off = 0
        for a, c in zip(g_assets[p], g_counts[p]):
            c = int(c)
            h = g_lo[p][off:off + c].astype(np.uint64) | (
                g_hi[p][off:off + c].astype(np.uint64) << np.uint64(32))
            out[int(a)] = (h, g_sz[p][off:off + c].copy())
            off += c
    return out


def barrier(name: str = "sync") -> None:
    """Wait for every process (over gloo); ``name`` labels the point."""
    if process_info()[1] > 1:
        dist.barrier(group=_host_group())


def upsync_sharded(source_storage, source_root: str, block_store,
                   target_chunk_size: int = C.DEFAULT_TARGET_CHUNK_SIZE,
                   target_block_size: int = C.DEFAULT_TARGET_BLOCK_SIZE,
                   max_chunks_per_block: int = C.DEFAULT_MAX_CHUNKS_PER_BLOCK,
                   hash_identifier: int = C.HASH_TYPE_BLAKE3,
                   compression_tag: int = C.COMPRESSION_TYPE_LZ4_DEFAULT,
                   workers: int = 8, device="cuda", progress=null_progress):
    """The N-process upsync: returns (version_index, version_store_index)
    on every process (identical); blocks are written by their owning
    process only.  ``device`` is the chunk+hash device of every process
    (``api.upsync``'s); the block store brings its own codec device."""
    from longtail_tpu_torch import api
    from longtail_tpu_torch.core import store_algebra
    from longtail_tpu_torch.core.dedup import create_missing_content
    from longtail_tpu_torch.core.indexing import (
        FileInfos,
        assemble_chunked_assets,
        build_version_index_from_chunked,
        chunk_assets,
        get_files_recursively,
    )
    from longtail_tpu_torch.core.write import write_content
    from longtail_tpu_torch.ops.hash_registry import get_hasher

    pid, nproc = process_info()
    if nproc == 1:
        return api.upsync(
            source_storage, source_root, block_store,
            target_chunk_size=target_chunk_size,
            target_block_size=target_block_size,
            max_chunks_per_block=max_chunks_per_block,
            hash_identifier=hash_identifier,
            compression_tag=compression_tag, workers=workers,
            device=device, progress=progress)
    file_infos = get_files_recursively(source_storage, source_root,
                                       workers=workers)
    mine = shard_assets(file_infos, pid, nproc)

    # chunk my shard through the local data plane
    sub = FileInfos(
        paths=[file_infos.paths[int(a)] for a in mine],
        sizes=file_infos.sizes[mine] if len(mine) else
        np.zeros(0, np.uint64),
        permissions=file_infos.permissions[mine] if len(mine) else
        np.zeros(0, np.uint16))
    ca_sub = chunk_assets(source_storage, source_root, sub,
                          hash_identifier, target_chunk_size,
                          workers=workers, device=device)
    results = [(np.zeros(0, np.uint64), np.zeros(0, np.uint32))
               for _ in range(file_infos.count)]
    for j, a in enumerate(mine):
        s = ca_sub.asset_chunk_start_index[j]
        c = ca_sub.asset_chunk_counts[j]
        results[int(a)] = (ca_sub.chunk_hashes[s:s + c],
                           ca_sub.chunk_sizes[s:s + c])

    # the collective: everyone ends up with every asset's chunks
    results = exchange_chunk_results(mine, results, file_infos.count)

    hasher = get_hasher(hash_identifier)
    asset_tags = np.full(file_infos.count, compression_tag, np.uint32)
    ca = assemble_chunked_assets(results, file_infos, hasher, asset_tags)
    version_index = build_version_index_from_chunked(
        ca, file_infos, hash_identifier, target_chunk_size)

    # deterministic plan, identical on every process; blocks shard by
    # index and each process uploads its own slice.  The barrier after
    # the snapshot keeps a fast process's new .lrb files out of a slow
    # process's get_existing_content (a rebuild-by-scan on a fresh
    # store), which would give the two different plans and leave some
    # blocks written by nobody.
    existing = block_store.get_existing_content(version_index.chunk_hashes)
    missing = create_missing_content(
        existing, version_index, target_block_size, max_chunks_per_block)
    barrier("upsync-plan-snapshot")
    my_blocks = range(pid, missing.block_count, nproc)
    write_content(source_storage, block_store, missing, version_index,
                  source_root, workers=workers,
                  block_indexes=my_blocks, progress=progress)
    block_store.flush()
    barrier("upsync-content")
    return version_index, store_algebra.merge_store_index(missing, existing)


def downsync_sharded(block_store, target_storage, target_root: str,
                     version_index,
                     min_block_usage_percent: int = 0,
                     retain_permissions: bool = True,
                     workers: int = 8, progress=null_progress) -> None:
    """N-process reconstruction into a shared target: every process
    computes the same plan (store coverage for the version's chunks),
    blocks are dealt round-robin by index, each process fetches, decodes
    and scatters only its own slice, and process 0 retains permissions
    after the barrier.  The target must be reachable from every process;
    pre-sizing and directory creation are idempotent, so the processes
    need no coordination beyond the plan-snapshot and completion
    barriers."""
    from longtail_tpu_torch.core.change import change_version
    from longtail_tpu_torch.core.change import (
        retain_permissions as _retain_permissions,
    )

    pid, nproc = process_info()
    # other processes may have merged blocks into the store since this
    # process cached its index view (e.g. a sharded upsync just before)
    reload = getattr(block_store, "reload_index", None)
    if reload is not None:
        reload()
    store_index = block_store.get_existing_content(
        version_index.chunk_hashes, min_block_usage_percent)
    # the plan must be identical everywhere: snapshot before any process
    # mutates the target
    barrier("downsync-plan-snapshot")
    mine = range(pid, store_index.block_count, nproc)
    change_version(block_store, target_storage, version_index,
                   store_index, target_root,
                   retain_permissions_flag=False,
                   workers=workers, block_indexes=mine,
                   progress=progress)
    barrier("downsync-content")
    if pid == 0 and retain_permissions:
        _retain_permissions(target_storage, version_index, target_root)
    barrier("downsync-done")


def _dryrun_main() -> None:
    """One process of the N-process dry run.  Its parameters ride
    environment variables: LT_MH_COORD (host:port of rank 0),
    LT_MH_NPROC, LT_MH_PID, LT_MH_SRC (source tree), LT_MH_STORE (the
    shared FS block store), LT_MH_LVI (the .lvi process 0 writes),
    LT_MH_OUT (optional: the shared target of a sharded downsync),
    LT_MH_TCS (target chunk size, 1024) and LT_MH_DEVICE (the chunk+hash
    and codec device: cuda, the default; cpu; host).  Blocks are LZ4.
    Its last line of output is a JSON object of its kernel launches."""
    import os

    from longtail_tpu_torch.cli import DEVICE_NAMES
    from longtail_tpu_torch.stores.compressblockstore import (
        CompressBlockStore,
    )
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage

    device = DEVICE_NAMES[os.environ.get("LT_MH_DEVICE", "cuda")]
    initialize(os.environ["LT_MH_COORD"],
               int(os.environ["LT_MH_NPROC"]),
               int(os.environ["LT_MH_PID"]))
    try:
        st = FSStorage()
        store = CompressBlockStore(
            FSBlockStore(FSStorage(), os.environ["LT_MH_STORE"]),
            device=device)
        vi, _ = upsync_sharded(
            st, os.environ["LT_MH_SRC"], store,
            target_chunk_size=int(os.environ.get("LT_MH_TCS", "1024")),
            workers=4, device=device)
        if process_info()[0] == 0:
            with open(os.environ["LT_MH_LVI"], "wb") as f:
                f.write(vi.to_bytes())
        barrier("dryrun-upsync-done")
        # the serve direction, sharded over the same processes: blocks
        # dealt round-robin, scattered into one shared target
        out = os.environ.get("LT_MH_OUT")
        if out:
            downsync_sharded(store, st, out, vi, workers=4)
        barrier("dryrun-done")
        # the last line: this process's kernel launches
        print(json.dumps({"rank": process_info()[0],
                          "launches": _launch_counts()}), flush=True)
    finally:
        dist.destroy_process_group()


def _launch_counts() -> dict:
    """The launch count of each kernel wrapper in this process."""
    from longtail_tpu_torch.ops import (
        blake2_kernel,
        blake3_kernel,
        entropy_kernel,
        pack,
    )
    from longtail_tpu_torch.parallel import stage1

    return {"scan": stage1.scan.LAUNCHES, "walk": stage1.walk.LAUNCHES,
            "pack": pack.pack.LAUNCHES,
            "blake3": blake3_kernel.hash_chunks_device.LAUNCHES,
            "blake2": blake2_kernel.hash_chunks_device.LAUNCHES,
            "hufpack": entropy_kernel.hufpack_frame.LAUNCHES}


if __name__ == "__main__":
    _dryrun_main()
