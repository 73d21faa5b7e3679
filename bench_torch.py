#!/usr/bin/env python
"""Benchmark harness of the PyTorch/CUDA port: prints ONE JSON line to stdout.

The port's counterpart of ``bench.py``: the same nine ``--mode``s, flags
and defaults, each mode measuring the same work through
``longtail_tpu_torch`` and returning the same keys as ``bench.py``'s
dict for that mode, plus ``device`` ({"name", "power_limit", "count"} of
the card from nvidia-smi, or {"name": "cpu"}).  The headline,
``chunk_hash_compress``, is chunk (CDC scan + walk) + BLAKE3 hash + the
stage-4 anchor scan with host LZ4 assembly, in GB/s over batches resident
on the card (``DevicePartIndexer(compress=True)``).  ``vs_baseline`` is
value / 5.0, as in ``bench.py``.

``--device`` (default ``cuda``) is where the device work runs: ``cuda``
runs the kernels and needs a card (without one the script exits
non-zero; it never falls back to the CPU), ``cpu`` runs the kernels'
plain versions, which is how the tests drive it at small sizes.

The synthetic corpus has ``bench.py``'s structure (the 8-region mix of
``structured_rows``, 64 MiB segments with a duplicate every 8th) but not
its bytes: the resident batch is made on the host from
``np.random.default_rng(7)`` and uploaded once, where ``bench.py`` draws
it with ``jax.random`` on the device.

Human-readable progress goes to stderr; stdout carries only the JSON line.

Usage: python bench_torch.py [--gib N] [--mode MODE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from longtail_tpu_torch import api
from longtail_tpu_torch.formats import constants as C
from longtail_tpu_torch.ops import (
    blake3,
    cdc,
    entropy_kernel,
    lz4,
    zstd as _z,
    zstd_device,
    zstd_frame,
)
from longtail_tpu_torch.ops.device_entropy import encode_literals_device
from longtail_tpu_torch.parallel.device_decode import decode_block_device
from longtail_tpu_torch.parallel.device_match import (
    fast_anchors,
    fast_block_anchors,
)
from longtail_tpu_torch.parallel.pipeline import (
    DevicePartIndexer,
    MeshPartIndexer,
    resolve_device,
)
from longtail_tpu_torch.stores.compressblockstore import CompressBlockStore
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
from longtail_tpu_torch.stores.storage import FSStorage

BASELINE_GBPS = 5.0
MODES = ("chunk_hash_compress", "chunk_hash", "mesh_chunk_hash", "compress",
         "device_compress", "device_decode", "device_entropy", "downsync",
         "real")
# bench.py's hard-coded sizes, keyword defaults of the modes
BLOCK_BYTES = 8 << 20            # a store block (data plane, device_compress)
WARMUP_BATCHES = 8               # least warm-up batches (data plane, mesh)
MESH_BATCH_BYTES = 256 << 20     # per device (mesh_chunk_hash)
LZ4_BATCH_BYTES = 64 << 20       # device_compress's word batch
DECODE_BLOCK_BYTES = 4 << 20     # device_decode's blocks
ENTROPY_STREAMS = 128            # device_entropy's resident streams ...
ENTROPY_STREAM_BYTES = 128 << 10  # ... of one zstd block's literals each
ENTROPY_BLOCK_BYTES = 4 << 20    # device_entropy's device-zstd block
DOWNSYNC_FILE_BYTES = 64 << 20   # downsync's files


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_corpus(total_bytes: int, seed: int = 7) -> np.ndarray:
    """Synthetic corpus with realistic structure at every layer: each
    64 MiB segment is a fresh structured batch (see structured_rows,
    compresses ~2.5-4x like the reference's game-content corpora), and
    every 8th segment duplicates an earlier one so chunk-level dedup sees
    real hits."""
    rng = np.random.default_rng(seed)
    seg = 64 << 20
    out = np.empty(-(-total_bytes // seg) * seg, np.uint8)
    n_seg = len(out) // seg
    R = seg // 128
    for j in range(n_seg):
        if j >= 5 and j % 8 == 7:
            out[j * seg:(j + 1) * seg] = out[(j - 5) * seg:(j - 4) * seg]
            continue
        base = rng.integers(0, 256, (3 * (R // 8), 128), dtype=np.uint8)
        out[j * seg:(j + 1) * seg] = structured_rows(base, np).reshape(-1)
    return out[:total_bytes]


def parts_of(buf: np.ndarray, part_bytes: int):
    for off in range(0, len(buf), part_bytes):
        yield off, buf[off:off + part_bytes]


def structured_rows(base_rows, xp):
    """Build a realistic 8-region corpus batch from random base rows:
    2/8 short-period data (4.25 KiB tiles: text-analog), 1/8 zeros,
    2/8 24 KiB tile repeats, 3/8 incompressible noise.  base_rows carries
    the 3/8 of unique randomness; the output has 8/3 x base rows."""
    r8 = base_rows.shape[0] // 3
    text = xp.tile(base_rows[:34], (2 * r8 // 34 + 1, 1))[: 2 * r8]
    zeros = xp.zeros((r8, 128), dtype=base_rows.dtype)
    tiled = xp.tile(base_rows[34:226], (2 * r8 // 192 + 1, 1))[: 2 * r8]
    noise = base_rows
    return xp.concatenate([text, zeros, tiled, noise], axis=0)


def check(ok: bool, msg: str) -> None:
    """Raise AssertionError(msg) unless ok (an assert that -O keeps)."""
    if not ok:
        raise AssertionError(msg)


def sync(devices) -> None:
    """Wait for every CUDA device of devices (one device or a list)."""
    for d in devices if isinstance(devices, list) else [devices]:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def host_ms(fn, device, reps: int = 10) -> float:
    """Mean host-clock ms of fn() over reps calls ending in a wait for
    the device, after one warm-up call."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def device_info(device) -> dict:
    """The key ``device`` of every result: the card's name and power
    limit as nvidia-smi gives them and the count of cards, or
    {"name": "cpu"}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu"}
    line = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit,
            "count": torch.cuda.device_count()}


def bench_data_plane(total_bytes: int, target_chunk_size: int,
                     with_compress: bool, device, verify: bool = True,
                     batch_mib: int = 256, *, block_bytes: int = BLOCK_BYTES,
                     warmup_batches: int = WARMUP_BATCHES) -> dict:
    """Device data-plane throughput over part batches resident on the
    device: chunk (CDC scan + walk) + BLAKE3 hash, and optionally + the
    stage-4 anchor scan (from the scan's bin-mins) with host LZ4 assembly
    on two threads against a host mirror of the batch (the full
    chunk+hash+compress metric of BASELINE.md).

    Host planning, every result fetch and (with_compress) the assembly
    are inside the timed window, which ends when every batch's results
    are on the host and the device is idle.  Each batch is the resident
    one XOR-perturbed, each half with its own salt, inside the window as
    in bench.py; the perturbation preserves byte-equality structure, so
    anchors stay valid against the unperturbed mirror and assembly output
    sizes are exact.  Its cost alone is logged.

    verify=True pins correctness on the record: one batch's chunk sizes
    AND hashes are compared against the host oracle (native CDC +
    BLAKE3), and the assembled blocks are decompressed and compared to
    the mirror bit-for-bit.  A wrong cut, hash, or match fails the bench.
    """
    device = resolve_device(device)
    log(f"device: {device_info(device)}")
    indexer = DevicePartIndexer(target_chunk_size, device,
                                batch_bytes=batch_mib << 20,
                                compress=with_compress)
    B, P = indexer.lanes, indexer.part_bytes
    batch_bytes = B * P
    blocks_per_batch = batch_bytes // block_bytes
    n_batches = max(1, -(-total_bytes // batch_bytes))
    log(f"workload: {n_batches} batches x {batch_bytes >> 20} MiB "
        f"({B} lanes x {P >> 10} KiB parts), structured corpus")

    R = batch_bytes // 128
    t0 = time.perf_counter()
    base = np.random.default_rng(7).integers(0, 256, (3 * (R // 8), 128),
                                             dtype=np.uint8)
    mirror = structured_rows(base, np)               # (R, 128) u8
    mirror_flat = mirror.reshape(-1)
    mirror_blocks = [
        mirror_flat[b * block_bytes:(b + 1) * block_bytes].tobytes()
        for b in range(blocks_per_batch)]
    batch_dev = torch.from_numpy(mirror_flat).to(device)
    sync(device)
    log(f"host corpus + upload: {time.perf_counter() - t0:.1f}s")
    half = (R // 2) * 128

    def perturbed(b, i):
        # two u8 salts, equality structure preserved within each half
        return torch.cat([b[:half] ^ (i % 255 + 1),
                          b[half:] ^ ((i // 255) % 255 + 1)])

    log(f"perturbation alone: "
        f"{host_ms(lambda: perturbed(batch_dev, 0), device):.4f} ms per "
        f"{batch_bytes >> 20} MiB batch")
    lengths = np.full((B,), P, dtype=np.int32)

    def run(n: int, compress: bool):
        stage1: deque = deque()
        stage2: deque = deque()
        asm_futures = []
        n_chunks = n_bytes = 0

        asm_buf = threading.local()

        def assemble(anchors):
            # per-thread reusable dst: the into-variant skips the memset
            # + copy-out of the bytes API
            dst = getattr(asm_buf, "dst", None)
            if dst is None:
                dst = asm_buf.dst = np.empty(
                    lz4.compress_bound(block_bytes), np.uint8)
            total = 0
            for b, (apos, aref) in enumerate(anchors[:blocks_per_batch]):
                r = lz4.assemble_anchors_into(
                    mirror_blocks[b], apos, aref, dst)
                # store-raw-when-bigger, as the reference's
                # compressblockstore does (longtail_compressblockstore.c:86)
                total += min(r, block_bytes)
            return total

        def drain(item):
            nonlocal n_chunks, n_bytes
            entry, ch = item
            for _, sizes, hashes in indexer.retire(entry):
                n_chunks += len(hashes)
                n_bytes += int(np.asarray(sizes, dtype=np.int64).sum())
            if ch is not None:
                anchors = indexer.collect_compress(ch)
                asm_futures.append(asm_pool.submit(assemble, anchors))

        def plan(entry):
            e = indexer.plan_hash(entry, keep_words=compress)
            return e, (indexer.submit_compress(e, block_bytes)
                       if compress else None)

        d = indexer.queue_depth
        with ThreadPoolExecutor(max_workers=2) as asm_pool:
            for i in range(n):
                stage1.append(indexer.submit(
                    [None] * B, perturbed(batch_dev, i), lengths))
                if len(stage1) >= d:
                    stage2.append(plan(stage1.popleft()))
                if len(stage2) >= d:
                    drain(stage2.popleft())
            while stage1:
                stage2.append(plan(stage1.popleft()))
            while stage2:
                drain(stage2.popleft())
            comp_bytes = sum(f.result() for f in asm_futures)
        sync(device)
        return n_chunks, n_bytes, comp_bytes

    t0 = time.perf_counter()
    n_warm = max(warmup_batches, n_batches // 2)
    n_chunks, _, _ = run(n_warm, with_compress)
    dt = time.perf_counter() - t0
    log(f"warmup: {dt:.2f}s ({n_warm} batches, kernel builds included, "
        f"{n_warm * batch_bytes / dt / 1e9:.3f} GB/s; {n_chunks} chunks)")

    result = {}
    if with_compress:
        t0 = time.perf_counter()
        n_chunks, n_bytes, comp = run(n_batches, True)
        dt = time.perf_counter() - t0
        check(n_bytes == n_batches * batch_bytes, f"{n_bytes} bytes chunked")
        gbps = n_bytes / dt / 1e9
        ratio = n_bytes / max(comp, 1)
        log(f"chunk+hash+compress: {dt:.2f}s  {gbps:.3f} GB/s  "
            f"{n_chunks} chunks  ratio {ratio:.2f}x")
        result.update({
            "metric": "chunk_hash_compress_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
            "vs_baseline": round(gbps / BASELINE_GBPS, 3),
            "compress_ratio": round(ratio, 2),
        })
        # context sub-metric: chunk+hash alone on a shorter run
        sub = min(n_batches, 16)
        t0 = time.perf_counter()
        _, nb, _ = run(sub, False)
        result["chunk_hash_gbps"] = round(nb / (time.perf_counter() - t0)
                                          / 1e9, 3)
        log(f"chunk+hash only (context): {result['chunk_hash_gbps']} GB/s")
        # context: the default codec's device path (zstd from the anchors,
        # the Huffman pack once per frame) vs host level 3, one batch
        if zstd_device._zstd_api() is not None:
            zt = h3 = raw = 0
            t0 = time.perf_counter()
            for blk in mirror_blocks:
                zout = zstd_device.compress_block(blk, device=device)
                check(_z.decompress(zout, len(blk)) == blk,
                      "device zstd block does not decode")
                zt += len(zout)
                h3 += len(_z.compress(blk, 3))
                raw += len(blk)
            result["zstd_device_ratio"] = round(raw / zt, 2)
            result["zstd_level3_ratio"] = round(raw / h3, 2)
            log(f"zstd device (context, full batch): ratio "
                f"{result['zstd_device_ratio']}x vs host level3 "
                f"{result['zstd_level3_ratio']}x (decode verified; "
                f"{time.perf_counter() - t0:.1f}s)")
    else:
        t0 = time.perf_counter()
        n_chunks, n_bytes, _ = run(n_batches, False)
        dt = time.perf_counter() - t0
        check(n_bytes == n_batches * batch_bytes, f"{n_bytes} bytes chunked")
        gbps = n_bytes / dt / 1e9
        log(f"chunk+hash: {dt:.2f}s  {gbps:.3f} GB/s  {n_chunks} chunks")
        result.update({
            "metric": "chunk_hash_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
            "vs_baseline": round(gbps / BASELINE_GBPS, 3),
        })

    if verify:
        result["verified"] = verify_data_plane(
            indexer, batch_dev, lengths, mirror, mirror_blocks,
            target_chunk_size, with_compress, block_bytes)
    return result


def verify_data_plane(indexer, batch_dev, lengths, mirror, mirror_blocks,
                      target_chunk_size: int, with_compress: bool,
                      block_bytes: int = BLOCK_BYTES) -> bool:
    """Bit-exactness on the record: device chunk sizes + hashes vs the
    host oracle (native CDC + BLAKE3), and device-anchored LZ4 blocks
    decode back to the mirror.  Raises on any mismatch."""
    mn, av, mx = C.chunker_params_from_target(target_chunk_size)
    B, P = indexer.lanes, indexer.part_bytes
    entry = indexer.plan_hash(
        indexer.submit([None] * B, batch_dev, lengths),
        keep_words=with_compress)
    ch = indexer.submit_compress(entry, block_bytes) if with_compress \
        else None
    flat = mirror.reshape(-1)
    t0 = time.perf_counter()
    for lane, (_, sizes, hashes) in enumerate(indexer.retire(entry)):
        data = flat[lane * P: lane * P + int(lengths[lane])]
        ref_ends = cdc.chunk_part(data, mn, av, mx)
        ref_sizes = np.diff(np.concatenate([[0], ref_ends]))
        check(np.array_equal(sizes.astype(np.int64), ref_sizes),
              f"lane {lane}: chunk sizes diverge from host oracle")
        starts = np.concatenate([[0], ref_ends[:-1]]).astype(np.int64)
        ref_hashes = blake3.hash64_ranges(
            data, starts, ref_sizes.astype(np.int64))
        check(np.array_equal(hashes, ref_hashes),
              f"lane {lane}: chunk hashes diverge from host oracle")
    log(f"verify: {B} lanes chunk+hash bit-exact vs host oracle "
        f"({time.perf_counter() - t0:.1f}s)")
    if ch is not None:
        anchors = indexer.collect_compress(ch)
        for b in range(min(len(mirror_blocks), len(anchors))):
            apos, aref = anchors[b]
            out = lz4.assemble_anchors(mirror_blocks[b], apos, aref)
            check(lz4.decompress(out, len(mirror_blocks[b]))
                  == mirror_blocks[b], f"block {b}: lz4 roundtrip mismatch")
        log(f"verify: {len(anchors)} device-anchored LZ4 blocks decode "
            "bit-exact")
    return True


def bench_mesh_chunk_hash(total_bytes: int, target_chunk_size: int, device,
                          *, batch_bytes_per_dev: int = MESH_BATCH_BYTES,
                          warmup_batches: int = WARMUP_BATCHES) -> dict:
    """The mesh data plane on every card (or on the CPU): the resident
    batch loop of the main bench, one resident batch per device, batches
    dealt round-robin over MeshPartIndexer's per-device pipelines.  The
    window ends with every device idle."""
    device = resolve_device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    mesh_ix = MeshPartIndexer(target_chunk_size, devices,
                              batch_bytes_per_dev=batch_bytes_per_dev)
    n = len(devices)
    B, P = mesh_ix.indexers[0].lanes, mesh_ix.part_bytes
    batch_bytes = B * P
    n_batches = max(2 * n, -(-total_bytes // batch_bytes))
    R = batch_bytes // 128
    base = np.random.default_rng(7).integers(0, 256, (3 * (R // 8), 128),
                                             dtype=np.uint8)
    batch0 = torch.from_numpy(structured_rows(base, np).reshape(-1))
    per_dev = [batch0.to(d) for d in devices]
    sync(devices)
    lengths = np.full((B,), P, dtype=np.int32)

    def run(nb):
        stage1: deque = deque()
        stage2: deque = deque()
        n_bytes = 0
        d = mesh_ix.indexers[0].queue_depth * n
        for i in range(nb):
            k = i % n
            stage1.append((k, mesh_ix.indexers[k].submit(
                [None] * B, per_dev[k] ^ (i % 255 + 1), lengths)))
            if len(stage1) >= d:
                k, e = stage1.popleft()
                stage2.append((k, mesh_ix.indexers[k].plan_hash(e)))
            if len(stage2) >= d:
                k, e = stage2.popleft()
                for _, sizes, _ in mesh_ix.indexers[k].retire(e):
                    n_bytes += int(np.asarray(sizes, np.int64).sum())
        while stage1:
            k, e = stage1.popleft()
            stage2.append((k, mesh_ix.indexers[k].plan_hash(e)))
        while stage2:
            k, e = stage2.popleft()
            for _, sizes, _ in mesh_ix.indexers[k].retire(e):
                n_bytes += int(np.asarray(sizes, np.int64).sum())
        sync(devices)
        return n_bytes

    run(max(warmup_batches, 2 * n, n_batches // 3))
    t0 = time.perf_counter()
    n_bytes = run(n_batches)
    dt = time.perf_counter() - t0
    check(n_bytes == n_batches * batch_bytes, f"{n_bytes} bytes chunked")
    gbps = n_bytes / dt / 1e9
    log(f"mesh[{n} dev] chunk+hash: {dt:.2f}s {gbps:.3f} GB/s")
    return {
        "metric": "mesh_chunk_hash_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(gbps / BASELINE_GBPS, 3),
        "n_devices": n,
    }


def bench_device_compress(total_bytes: int, device, *,
                          batch_bytes: int = LZ4_BATCH_BYTES,
                          block_bytes: int = BLOCK_BYTES) -> dict:
    """Device LZ4 codec alone: the batched fast-tier anchor scan
    (parallel/device_match.py) + native host assembly, over resident
    word batches (input staging excluded).  Reports device-scan GB/s,
    host-assembly GB/s/core, ratio vs the host greedy encoder."""
    device = resolve_device(device)
    batch, block = batch_bytes, block_bytes
    total_bytes = max(batch, (total_bytes // batch) * batch)
    n_batches = total_bytes // batch
    rng = np.random.default_rng(11)
    text = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. ") * 12000
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes() * 40
    noise = rng.integers(0, 256, 1 << 20, np.uint8).tobytes()
    unit = text + bytes(1 << 19) + tile + noise
    corpus = (unit * (batch // len(unit) + 1))[:batch]
    w = torch.from_numpy(np.frombuffer(corpus, "<i4").copy()).to(device)
    fast_anchors(w, block // 4)
    sync(device)
    log(f"device-lz4 workload: {n_batches} x {batch >> 20} MiB batches")

    # device scan alone: perturb + scan per batch, the counts summed on
    # the device, one wait
    int(fast_anchors(w ^ 1, block // 4)[2].sum())
    t0 = time.perf_counter()
    acc = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(n_batches):
        acc += fast_anchors(w ^ (i + 2), block // 4)[2].sum()
    int(acc)
    sync(device)
    scan_dt = time.perf_counter() - t0
    scan_gbps = n_batches * batch / scan_dt / 1e9

    # assembly + ratio on one batch
    anchors = fast_block_anchors(w, block // 4)
    srcs = [corpus[b * block:(b + 1) * block]
            for b in range(batch // block)]
    lz4.assemble_anchors(srcs[0], *anchors[0])
    t0 = time.perf_counter()
    comp = 0
    for src, (apos, aref) in zip(srcs, anchors):
        comp += len(lz4.assemble_anchors(src, apos, aref))
    asm_gbps = batch / (time.perf_counter() - t0) / 1e9
    for b, (src, (apos, aref)) in enumerate(zip(srcs, anchors)):
        out = lz4.assemble_anchors(src, apos, aref)
        check(lz4.decompress(out, len(src)) == src,
              f"block {b}: device-anchored LZ4 does not decode")
    host_comp = sum(len(lz4.compress(s)) for s in srcs)
    log(f"device lz4 scan: {scan_gbps:.2f} GB/s; assembly "
        f"{asm_gbps:.2f} GB/s/core; ratio {batch / comp:.2f}x "
        f"(host greedy {batch / host_comp:.2f}x); decode verified")
    return {
        "metric": "device_lz4_scan_throughput",
        "value": round(scan_gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(scan_gbps / BASELINE_GBPS, 3),
        "compress_ratio": round(batch / comp, 2),
        "host_greedy_ratio": round(batch / host_comp, 2),
        "assembly_gbps_per_core": round(asm_gbps, 3),
    }


def bench_device_decode(total_bytes: int, device, *,
                        block_bytes: int = DECODE_BLOCK_BYTES) -> dict:
    """Batched LZ4 decode on the device (host parse + interval expansion
    + pointer-jumping gathers, parallel/device_decode.py) vs the host
    scalar decoder, bit-exact both ways.  The note states which is faster
    from this run's numbers: the production downsync decodes on the
    host."""
    device = resolve_device(device)
    block = block_bytes
    n_blocks = max(4, min(16, total_bytes // block))
    rng = np.random.default_rng(5)
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes()
    text = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. ") * 6000
    blocks = []
    for i in range(n_blocks):
        noise = rng.integers(0, 256, block // 4, np.uint8).tobytes()
        raw = ((text + bytes(1 << 18) + tile * 20 + noise)
               * 4)[:block]
        blocks.append((raw, lz4.compress(raw)))
    log(f"device-decode workload: {n_blocks} x {block >> 10} KiB blocks "
        f"(ratio {sum(len(r) for r, _ in blocks) / sum(len(c) for _, c in blocks):.2f}x)")

    # warm-up
    for raw, comp in blocks[:2]:
        check(decode_block_device(comp, len(raw), device) == raw,
              "device decode differs from the source")

    t0 = time.perf_counter()
    for raw, comp in blocks:
        out = decode_block_device(comp, len(raw), device)
        check(len(out) == len(raw), "device decode: wrong length")
    dev_dt = time.perf_counter() - t0
    dev_gbps = n_blocks * block / dev_dt / 1e9

    t0 = time.perf_counter()
    dst = np.empty(block, np.uint8)
    for raw, comp in blocks:
        lz4.decompress_into(comp, dst)
    host_dt = time.perf_counter() - t0
    host_gbps = n_blocks * block / host_dt / 1e9
    for b, (raw, comp) in enumerate(blocks):
        check(decode_block_device(comp, len(raw), device) == raw,
              f"block {b}: device decode differs from the source")
        n = lz4.decompress_into(comp, dst)
        check(dst[:n].tobytes() == raw,
              f"block {b}: host decode differs from the source")
    log(f"device decode: {dev_gbps:.3f} GB/s; host decode: "
        f"{host_gbps:.3f} GB/s/core (both bit-exact)")
    if dev_gbps < host_gbps:
        finding = (f"device decode is {host_gbps / dev_gbps:.1f}x slower "
                   "than one host core here: production downsync keeps "
                   "decode host-side")
    else:
        finding = (f"device decode is {dev_gbps / host_gbps:.1f}x faster "
                   "than one host core here, but production downsync "
                   "still decodes on the host")
    return {
        "metric": "device_lz4_decode_throughput",
        "value": round(dev_gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(dev_gbps / BASELINE_GBPS, 3),
        "host_decode_gbps_per_core": round(host_gbps, 3),
        "note": f"capability experiment on {device.type}: {finding}",
    }


def literal_stream() -> bytes:
    """device_entropy's literals: text, then 1 MiB of skewed bytes (16
    values at 5% each), eight times over."""
    rng = np.random.default_rng(13)
    text = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. " * 4000)
    skew = rng.choice(np.arange(256), size=1 << 20,
                      p=np.r_[np.full(16, 0.05),
                              np.full(240, 0.2 / 240)]).astype(np.uint8)
    return (text + skew.tobytes()) * 8


def literal_rows(stream: bytes, streams: int, stream_bytes: int):
    """(lits (streams, stream_bytes) u8 from stream repeated, their code
    table (256,) int32 from the histogram of all of them)."""
    n = streams * stream_bytes
    lits = np.frombuffer((stream * (n // len(stream) + 1))[:n],
                         np.uint8).reshape(streams, stream_bytes)
    _, code_val, code_len = zstd_frame.build_huffman(
        np.bincount(lits.reshape(-1), minlength=256).tolist())
    return lits, entropy_kernel.pack_code_table(code_val, code_len)


def bench_device_entropy(total_bytes: int, device, *,
                         streams: int = ENTROPY_STREAMS,
                         stream_bytes: int = ENTROPY_STREAM_BYTES,
                         block_bytes: int = ENTROPY_BLOCK_BYTES) -> dict:
    """The Huffman entropy stage on the record: device-packed zstd
    literal sections (ops/device_entropy.py) over text-like literal
    streams: byte-identity with the host encoder, the pack's throughput
    over resident streams through the (S, n_pad) interface, and the full
    device-zstd block (device anchors + device literals entropy +
    from-spec frame, no libzstd in the encode path) vs libzstd level 3."""
    device = resolve_device(device)
    sections = []
    seg = stream_bytes                  # one zstd block's literals
    stream = literal_stream()
    n = max(seg, min(total_bytes, len(stream)))
    for off in range(0, n - seg + 1, seg):
        sections.append(stream[off:off + seg])

    # byte-identity on an exact-histogram size
    probe = sections[0][: 48 << 10]
    check(encode_literals_device(probe, device)
          == zstd_frame._encode_literals(probe),
          "device literals section differs from the host encoder's")

    # the pack over S resident streams, cycling 4 pre-staged batches, the
    # bit totals summed on the device and one wait; the code table from
    # the histogram of all S streams (bench.py builds it from 4)
    S, seg_pad = streams, stream_bytes
    lits_np, table = literal_rows(stream, S, seg_pad)
    tv = torch.from_numpy(table).to(device)
    bufs = [torch.from_numpy(np.roll(lits_np, k, axis=0)).to(device)
            for k in range(4)]
    n_lit = torch.full((S,), seg_pad, dtype=torch.int32, device=device)
    int(entropy_kernel.hufpack(bufs[0], n_lit, tv)[1].sum())      # warm
    for k in range(12):
        entropy_kernel.hufpack(bufs[k % 4], n_lit, tv)
    sync(device)
    iters = 16
    t0 = time.perf_counter()
    acc = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(iters):
        acc += entropy_kernel.hufpack(bufs[k % 4], n_lit, tv)[1].sum()
    int(acc)
    sync(device)
    dt = time.perf_counter() - t0
    kernel_raw = iters * S * seg_pad
    gbps = kernel_raw / dt / 1e9
    comp = sum(len(encode_literals_device(s, device)) for s in sections)
    raw = sum(len(s) for s in sections)
    log(f"device literals entropy ({S} resident streams of {seg_pad >> 10} "
        f"KiB): {gbps:.3f} GB/s; section ratio {raw / comp:.2f}x")

    # full device-zstd block, no libzstd in the encode path
    block = stream[:block_bytes]
    frame = zstd_device.compress_block(block, device=device)
    check(zstd_frame.decompress(frame, len(block)) == block,
          "device zstd frame does not decode")
    result = {
        "metric": "device_entropy_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(gbps / BASELINE_GBPS, 3),
        "section_ratio": round(raw / comp, 2),
        "device_zstd_ratio": round(len(block) / len(frame), 2),
    }
    if _z._load_native() is not None:
        check(_z.decompress(frame, len(block)) == block,
              "libzstd does not decode the device zstd frame")
        result["zstd_level3_ratio"] = round(
            len(block) / len(_z.compress(block, 3)), 2)
        log(f"device-zstd frame (device anchors + device entropy): ratio "
            f"{result['device_zstd_ratio']}x vs host L3 "
            f"{result['zstd_level3_ratio']}x (upstream-decode verified)")
    return result


def bench_compress(total_bytes: int, device=None) -> dict:
    """Host block-codec throughput, LZ4 path.  No device is involved;
    device is taken as every mode takes it."""
    buf = make_corpus(total_bytes)
    block = BLOCK_BYTES
    t0 = time.perf_counter()
    comp = 0
    for _, part in parts_of(buf, block):
        comp += len(lz4.compress(part.tobytes()))
    dt = time.perf_counter() - t0
    gbps = total_bytes / dt / 1e9
    log(f"lz4 compress: {dt:.2f}s {gbps:.3f} GB/s ratio "
        f"{total_bytes / comp:.2f}x")
    return {
        "metric": "lz4_compress_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(gbps / BASELINE_GBPS, 3),
    }


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(root) for f in fs)


def bench_real_data(total_bytes: int, path: str, device, *,
                    target_chunk_size: int = C.DEFAULT_TARGET_CHUNK_SIZE
                    ) -> dict:
    """Real on-disk data mode: api.upsync (zstd, 8 workers) of an actual
    directory tree (default /usr) on the device, its blocks through the
    device codecs, so ratio and dedup-rate claims rest on real content.
    Reports end-to-end upsync GB/s, compress ratio, and chunk-level dedup
    rate; skipped only when the path is absent."""
    device = resolve_device(device)
    if not os.path.isdir(path):
        log(f"real-data path {path} absent; skipping")
        return {"metric": "real_data_upsync_throughput", "value": 0.0,
                "unit": "GB/s", "vs_baseline": 0.0, "skipped": True}
    base = tempfile.mkdtemp(prefix="lt_real_")
    try:
        st = FSStorage()
        store = CompressBlockStore(
            FSBlockStore(st, os.path.join(base, "store")), device=device)
        t0 = time.perf_counter()
        vi, _ = api.upsync(
            st, path.rstrip("/"), store, target_chunk_size=target_chunk_size,
            compression_tag=C.COMPRESSION_TYPE_ZSTD_DEFAULT, workers=8,
            device=device)
        sync(device)
        dt = time.perf_counter() - t0
        raw = int(vi.asset_sizes.sum())
        stored = dir_bytes(os.path.join(base, "store"))
        # the version index's chunk table is already unique; dedup rate =
        # referenced asset bytes over unique chunk bytes
        unique_chunk_bytes = int(np.asarray(vi.chunk_sizes, np.int64).sum())
        dedup = raw / max(unique_chunk_bytes, 1)
        gbps = raw / dt / 1e9
        log(f"real-data upsync [{path}]: {raw / 1e9:.2f} GB in {dt:.1f}s "
            f"= {gbps:.3f} GB/s; ratio {raw / max(stored, 1):.2f}x; "
            f"chunk dedup {dedup:.2f}x ({vi.asset_count} assets, "
            f"{vi.chunk_count} chunks)")
        return {
            "metric": "real_data_upsync_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
            "vs_baseline": round(gbps / BASELINE_GBPS, 3),
            "compress_ratio": round(raw / max(stored, 1), 2),
            "chunk_dedup_ratio": round(dedup, 2),
            "raw_gb": round(raw / 1e9, 2),
            "path": path,
        }
    finally:
        shutil.rmtree(base, ignore_errors=True)


def bench_downsync(total_bytes: int, device, *,
                   file_bytes: int = DOWNSYNC_FILE_BYTES,
                   target_chunk_size: int = C.DEFAULT_TARGET_CHUNK_SIZE
                   ) -> dict:
    """End-to-end cold downsync (the reference's headline unpack
    benchmark): api.upsync of a synthetic tree on the device into a zstd
    fs store, then its reconstruction through the port's CLI in a
    subprocess: wall-clock GB/s plus the child's peak RSS.  Every file
    must come back byte for byte."""
    device = resolve_device(device)
    base = tempfile.mkdtemp(prefix="lt_bench_")
    child = None
    try:
        src = os.path.join(base, "src")
        os.makedirs(src)
        corpus = make_corpus(total_bytes)
        for i, part in parts_of(corpus, file_bytes):
            part.tofile(os.path.join(src, f"f{i // file_bytes:04d}.bin"))
        del corpus
        st = FSStorage()
        store = CompressBlockStore(
            FSBlockStore(st, os.path.join(base, "store")), device=device)
        t0 = time.perf_counter()
        vi, _ = api.upsync(
            st, src, store, target_chunk_size=target_chunk_size,
            compression_tag=C.COMPRESSION_TYPE_ZSTD_DEFAULT, workers=8,
            device=device)
        sync(device)
        up_dt = time.perf_counter() - t0
        lvi = os.path.join(base, "v.lvi")
        with open(lvi, "wb") as f:
            f.write(vi.to_bytes())
        stored = dir_bytes(os.path.join(base, "store"))
        log(f"upsync: {up_dt:.2f}s {total_bytes / up_dt / 1e9:.3f} GB/s "
            f"ratio {total_bytes / stored:.2f}x")

        out = os.path.join(base, "out")
        err_path = os.path.join(base, "child.err")
        t0 = time.perf_counter()
        with open(err_path, "wb") as err:
            child = subprocess.Popen(
                [sys.executable, "-m", "longtail_tpu_torch.cli", "--workers",
                 "8", "downsync",
                 "--storage-uri", os.path.join(base, "store"),
                 "--source-path", lvi, "--target-path", out],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.DEVNULL, stderr=err)
            # sample /proc: getrusage(RUSAGE_CHILDREN).ru_maxrss counts the
            # brief fork window where the child still shares this
            # process's (corpus-sized) pages, overstating the child's peak
            rss_kb = 0
            while child.poll() is None:
                try:
                    with open(f"/proc/{child.pid}/status") as f:
                        for ln in f:
                            if ln.startswith("VmRSS"):
                                rss_kb = max(rss_kb, int(ln.split()[1]))
                except FileNotFoundError:
                    break   # pid vanished between poll() and open()
                time.sleep(0.05)
            child.wait()    # reap; returncode is set after the break
        if child.returncode != 0:
            with open(err_path, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(f"downsync failed: {child.returncode}\n{tail}")
        dt = time.perf_counter() - t0
        gbps = total_bytes / dt / 1e9
        log(f"downsync: {dt:.2f}s {gbps:.3f} GB/s  peak RSS "
            f"{rss_kb / 1048576:.2f} GiB")
        # every file round-tripped
        names = sorted(os.listdir(src))
        check(sorted(os.listdir(out)) == names,
              "reconstruction holds other files")
        for name in names:
            check(filecmp.cmp(os.path.join(src, name),
                              os.path.join(out, name), shallow=False),
                  f"reconstruction mismatch: {name}")
        log(f"downsync: all {len(names)} files byte-identical")
        return {
            "metric": "downsync_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
            "vs_baseline": round(gbps / BASELINE_GBPS, 3),
            "peak_rss_gib": round(rss_kb / 1048576, 3),
            "upsync_gbps": round(total_bytes / up_dt / 1e9, 3),
            "compress_ratio": round(total_bytes / stored, 2),
        }
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(base, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=4.0,
                    help="workload size in GiB")
    ap.add_argument("--mode", default="chunk_hash_compress", choices=MODES)
    ap.add_argument("--path", default="/usr",
                    help="directory tree for --mode real")
    ap.add_argument("--target-chunk-size", type=int, default=32768)
    ap.add_argument("--batch-mib", type=int, default=256)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the bit-exactness verification phase")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; required) or cpu (the kernels' "
                         "plain versions)")
    args = ap.parse_args()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        log(f"bench_torch: {e}")
        return 1

    total = int(args.gib * 2**30)
    tcs = args.target_chunk_size
    if args.mode in ("chunk_hash_compress", "chunk_hash"):
        result = bench_data_plane(total, tcs,
                                  args.mode == "chunk_hash_compress", device,
                                  verify=not args.no_verify,
                                  batch_mib=args.batch_mib)
    elif args.mode == "mesh_chunk_hash":
        result = bench_mesh_chunk_hash(total, tcs, device)
    elif args.mode == "downsync":
        result = bench_downsync(total, device)
    elif args.mode == "device_compress":
        result = bench_device_compress(total, device)
    elif args.mode == "device_decode":
        result = bench_device_decode(total, device)
    elif args.mode == "device_entropy":
        result = bench_device_entropy(total, device)
    elif args.mode == "real":
        result = bench_real_data(total, args.path, device)
    else:
        result = bench_compress(total, device)
    result["device"] = device_info(device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
