"""Content writer (upload): assemble missing blocks from source assets and
put them into a block store.

Mirrors Longtail_WriteContent (src/longtail.c:4760) + WriteContentBlockJob
(:4559) + CreateAssetPartLookup (:4429): each block's chunks are read from
the first asset that contains them, at the byte offset implied by the asset's
chunk sequence.  Parallelism via the two-channel job graph
(parallel/jobgraph.py, the Bikeshed counterpart): assembly jobs on channel
0 feed per-block put jobs on channel 1, the same shape as the reference's
shed jobs + async PutStoredBlock completion.
"""

from __future__ import annotations

import threading

import numpy as np

from longtail_tpu_torch.parallel.jobgraph import JobGraph

from longtail_tpu_torch.formats.store_index import StoreIndex, StoredBlock
from longtail_tpu_torch.formats.version_index import VersionIndex
from longtail_tpu_torch.stores.storage import Storage
from longtail_tpu_torch.utils.cancel import check
from longtail_tpu_torch.utils.monitor import get_monitor, now_ns, record, span
from longtail_tpu_torch.utils.progress import null_progress


class AssetPartLookup:
    """chunk hash -> (asset_index, byte_offset, size), sorted-array backed
    (no Python dict: O(total_chunks) numpy build + O(log n) lookups)."""

    __slots__ = ("hashes", "asset", "offset", "size")

    def __init__(self, hashes, asset, offset, size):
        self.hashes = hashes
        self.asset = asset
        self.offset = offset
        self.size = size

    def __getitem__(self, h: int):
        i = int(np.searchsorted(self.hashes, np.uint64(h)))
        if i >= len(self.hashes) or int(self.hashes[i]) != int(h):
            raise KeyError(h)
        return int(self.asset[i]), int(self.offset[i]), int(self.size[i])

    def __contains__(self, h: int) -> bool:
        i = int(np.searchsorted(self.hashes, np.uint64(h)))
        return i < len(self.hashes) and int(self.hashes[i]) == int(h)

    def __len__(self) -> int:
        return len(self.hashes)


def create_asset_part_lookup(version_index: VersionIndex) -> AssetPartLookup:
    """chunk hash -> (asset_index, byte_offset, size); first asset wins
    (CreateAssetPartLookup, src/longtail.c:4429).  Vectorized: one
    flat_chunk_walk + np.unique (first occurrence in walk order = first
    asset, matching the reference's insert-if-absent)."""
    asset_of, flat_ci, offsets = version_index.flat_chunk_walk()
    hashes = version_index.chunk_hashes[flat_ci]
    uh, first = np.unique(hashes, return_index=True)
    return AssetPartLookup(
        uh, asset_of[first], offsets[first],
        version_index.chunk_sizes[flat_ci][first].astype(np.int64))


def write_content(source_storage: Storage, block_store,
                  missing_store_index: StoreIndex,
                  version_index: VersionIndex, version_root: str,
                  workers: int = 8, cancel_token=None,
                  block_indexes=None,
                  progress=null_progress) -> None:
    """Longtail_WriteContent (src/longtail.c:4760).

    ``block_indexes``: write only these blocks of the missing store
    index — the multi-host driver shards blocks across processes
    (parallel/multihost.py); every process sees the same deterministic
    missing-content plan and writes its own slice."""
    if missing_store_index.block_count == 0:
        return
    block_list = list(range(missing_store_index.block_count)) \
        if block_indexes is None else [int(b) for b in block_indexes]
    total = len(block_list)
    if total == 0:
        return
    with span("write") as s:
        part_lookup = create_asset_part_lookup(version_index)

        def assemble_block(b: int) -> StoredBlock:
            with span("write.assemble") as sp:
                check(cancel_token)
                mon = get_monitor()
                bh = int(missing_store_index.block_hashes[b])
                if mon:
                    mon.block_prepare(b, bh)
                hashes, sizes = missing_store_index.block_chunks(b)
                parts = bytearray()
                # group consecutive chunks from the same asset into one read
                # (WriteContentBlockJob read-range merging,
                # src/longtail.c:4640-4721)
                pend_asset = -1
                pend_offset = 0
                pend_size = 0

                def flush_read():
                    nonlocal pend_size
                    if pend_size:
                        path = version_index.path(pend_asset)
                        full = f"{version_root}/{path}" if version_root \
                            else path
                        parts.extend(source_storage.read(full, pend_offset,
                                                         pend_size))
                        pend_size = 0

                for h, size in zip(hashes, sizes):
                    asset, offset, psize = part_lookup[int(h)]
                    if psize != int(size):
                        raise ValueError(
                            f"chunk {int(h):#x} size mismatch {psize} != "
                            f"{int(size)}")
                    if asset == pend_asset and \
                            offset == pend_offset + pend_size:
                        pend_size += psize
                    else:
                        flush_read()
                        pend_asset, pend_offset, pend_size = \
                            asset, offset, psize
                flush_read()
                sp.n = len(parts)
                return StoredBlock(
                    block_index=missing_store_index.get_block_index(b),
                    block_data=bytes(parts))

        done = 0
        written = 0
        done_lock = threading.Lock()

        def put_block(b: int, block: StoredBlock, ready: int = 0) -> None:
            """ready: now_ns() when the block's assembly ended (0: untimed)."""
            nonlocal done, written
            if ready:
                record("write.put_wait", ready, now_ns())
            check(cancel_token)
            mon = get_monitor()
            bh = int(missing_store_index.block_hashes[b])
            raw = len(block.block_data)
            if mon:
                mon.block_save(b, bh, raw)
            with span("write.put", raw):
                block_store.put_stored_block(block)
            if mon:
                mon.block_save_complete(b, bh)
            with done_lock:
                done += 1
                written += raw
                progress(done, total)

        if workers > 1 and total > 1:
            # two-channel job graph (the reference's WriteContentBlockJob on
            # the shed + async PutStoredBlock park/resume, src/longtail.c:
            # 4559-4758): channel 0 assembles block payloads from source
            # reads, channel 1 carries the store puts, with a dependency
            # edge per block so puts overlap later assemblies.  A sliding
            # window (assemble_i waits on put_{i-window}) bounds in-flight
            # assembled blocks, and each put drops its payload reference —
            # without both, an upsync holds every assembled block in memory.
            graph = JobGraph(workers={0: workers, 1: max(2, workers // 2)})
            window = max(8, workers + workers // 2)
            put_ids: list[int] = []
            for j, b in enumerate(block_list):
                deps_a = [put_ids[j - window]] if j >= window else []
                a = graph.add(lambda b=b: (assemble_block(b), now_ns()),
                              deps=deps_a)

                def put(b=b, a=a):
                    put_block(b, *graph.result(a))
                    graph.drop_result(a)

                put_ids.append(graph.add(put, deps=[a], channel=1))
            graph.run()
        else:
            for b in block_list:
                put_block(b, assemble_block(b))
        s.n = written
