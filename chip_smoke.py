#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (longtail_tpu_torch) on one card.

    python3 chip_smoke.py [--gib 1.0] [--seed 7]

Phases, each printing a line; any failure raises and exits non-zero:

1. device: requires CUDA; prints nvidia-smi's name and power limit;
2. build: compiles the kernels (csrc/*.cu, nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (one 64 MiB batch of 2 x 32 MiB parts, one
   ragged; pack and BLAKE3 on every size class of that batch's chunks
   plus a size-0 padding tail), demanding exact equality (all integer),
   with CUDA-event times of both;
4. main path: api.upsync(device=cuda) of a synthetic asset tree (--gib
   GiB, default 1) into an FSBlockStore behind a CompressBlockStore at
   the library defaults (32 KiB target chunk, 64 MiB batches, 8 MiB
   blocks, LZ4); prints wall time, GB/s and each kernel's launch count;
5. held to the host: the .lvi must equal the host path's byte for byte,
   and a host downsync of the store must reproduce the tree byte for byte.

The second-to-last line is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.  Imports no jax.
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
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def structured_piece(rng, n_bytes: int) -> np.ndarray:
    """bench.py's structured mix, without jax: of every 8 MiB, 2/8
    short-period data (4.25 KiB tiles, text-like), 1/8 zeros, 2/8 24 KiB
    tile repeats and 3/8 noise."""
    R = max(-(-n_bytes // 128), 2048)
    r8 = R // 8
    base = rng.integers(0, 256, (3 * r8, 128), dtype=np.uint8)
    text = np.tile(base[:34], (2 * r8 // 34 + 1, 1))[: 2 * r8]
    zeros = np.zeros((r8, 128), np.uint8)
    tiled = np.tile(base[34:226], (2 * r8 // 192 + 1, 1))[: 2 * r8]
    return np.concatenate([text, zeros, tiled, base]).reshape(-1)[:n_bytes]


def structured(rng, n_bytes: int) -> np.ndarray:
    piece = 8 << 20
    return np.concatenate(
        [structured_piece(rng, min(piece, n_bytes - o))
         for o in range(0, n_bytes, piece)] or [np.zeros(0, np.uint8)])


def make_tree(root: str, total: int, seed: int) -> int:
    """Asset tree of ~total bytes: multi-part files with ragged last parts,
    one file of exactly 32 MiB, one duplicate file, ~40 small files (host
    path), one empty file, nested directories.  Returns bytes written."""
    rng = np.random.default_rng(seed)
    mib = 1 << 20
    small_sizes = rng.integers(1 << 10, 400 << 10, 40)
    exact = min(32 * mib, max(total // 8, mib))
    big_each = max((total - exact - int(small_sizes.sum())) // 6, mib)
    files = {}
    for i in range(5):
        ragged = big_each - (i * 1234567 + 4321) % (7 * mib)
        files[f"content/level{i % 2}/pak_{i}.bin"] = max(ragged, mib + 1)
    files["content/exact_32mib.bin"] = exact
    for k, n in enumerate(small_sizes):
        files[f"content/small/d{k % 4}/s{k:02d}.dat"] = int(n)
    written = 0
    for rel, n in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        structured(rng, n).tofile(path)
        written += n
    dup = os.path.join(root, "content/copies/deep/pak_0_copy.bin")
    os.makedirs(os.path.dirname(dup), exist_ok=True)
    shutil.copyfile(os.path.join(root, "content/level0/pak_0.bin"), dup)
    written += files["content/level0/pak_0.bin"]
    open(os.path.join(root, "content/empty.txt"), "wb").close()
    os.makedirs(os.path.join(root, "content/empty_dir"), exist_ok=True)
    return written


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| over paired int tensors (0 when equal)."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def check_kernels(seed: int) -> list:
    """Phase 3: each kernel against its plain version on the card."""
    import torch

    from longtail_tpu_torch.ops import blake3, blake3_kernel
    from longtail_tpu_torch.parallel import pipeline, stage1
    from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig

    dev = torch.device("cuda")
    cfg = ChunkerConfig.from_target(32768)
    P = 32768 * 1024
    plan = stage1.Stage1Plan(cfg, 2, P)
    rng = np.random.default_rng(seed)
    flat = structured(rng, 2 * P)
    lengths = np.array([P, P - 12345 * 7], np.int32)
    flat[P + lengths[1]:] = 0
    batch = torch.from_numpy(flat).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    table = stage1.hash_table(dev)
    rows = []

    def row(name, src, rep, err, ms, plain_ms):
        log(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms "
            f"(plain PyTorch {plain_ms:.4f} ms)")
        if err != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version (max_abs_err {err})")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})

    got = stage1.scan(batch, lens, table, plan)
    want = stage1.scan_plain(batch, lens, table, plan)
    row("scan", stage1.SOURCE, stage1.SCAN_REPLACES,
        max_abs_err(got, want),
        cuda_ms(lambda: stage1.scan(batch, lens, table, plan), 20),
        cuda_ms(lambda: stage1.scan_plain(batch, lens, table, plan), 2))

    suf = stage1.suffix_min(got[0], plan)
    wout = stage1.walk(lens, *got, suf, plan)
    wplain = stage1.walk_plain(lens, *got, suf, plan)
    row("walk", stage1.SOURCE, stage1.WALK_REPLACES,
        max_abs_err([wout], [wplain]),
        cuda_ms(lambda: stage1.walk(lens, *got, suf, plan), 5),
        cuda_ms(lambda: stage1.walk_plain(lens, *got, suf, plan), 1))

    sizes, n, amb = stage1.unpack_walk(wout.cpu().numpy(), plan)
    log(f"batch: {n.tolist()} chunks per part, ambiguous {amb.tolist()}")
    all_st, all_sz = [], []
    for b in range(plan.lanes):
        sz = sizes[b, :n[b]].astype(np.int64)
        all_st.append(b * P + np.concatenate([[0], np.cumsum(sz)[:-1]]))
        all_sz.append(sz)
    st_all, sz_all = np.concatenate(all_st), np.concatenate(all_sz)
    cap, floor = pipeline.pow2_cap(cfg.padded_chunk), pipeline.class_floor(cfg)
    padded = pipeline._pow2_padded(sz_all, cap, floor)
    pack_err = hash_err = 0
    t = {"pack": 0.0, "pack_plain": 0.0, "hash": 0.0, "hash_plain": 0.0}
    for cls in np.unique(padded):
        idx = np.flatnonzero(padded == cls)
        tail = np.zeros(5, np.int64)                 # size-0 padding rows
        st = torch.from_numpy(np.concatenate([st_all[idx], tail])
                              .astype(np.int32)).to(dev)
        sz = torch.from_numpy(np.concatenate([sz_all[idx], tail])
                              .astype(np.int32)).to(dev)
        cls = int(cls)
        words = pipeline.pack(batch, st, sz, cls)
        pack_err = max(pack_err, max_abs_err(
            [words], [pipeline.pack_plain(batch, st, sz, cls)]))
        t["pack"] += cuda_ms(lambda: pipeline.pack(batch, st, sz, cls), 10)
        t["pack_plain"] += cuda_ms(
            lambda: pipeline.pack_plain(batch, st, sz, cls), 2)
        hash_err = max(hash_err, max_abs_err(
            blake3_kernel.hash_chunks_words_device(words, sz),
            blake3.hash_chunks_words(words, sz)))
        t["hash"] += cuda_ms(
            lambda: blake3_kernel.hash_chunks_words_device(words, sz), 10)
        t["hash_plain"] += cuda_ms(
            lambda: blake3.hash_chunks_words(words, sz), 1)
        log(f"class {cls >> 10} KiB: {len(idx)} chunks + 5 padding rows")
    row("pack", pipeline.PACK_SOURCE, pipeline.PACK_REPLACES, pack_err,
        t["pack"], t["pack_plain"])
    row("blake3", blake3_kernel.SOURCE, blake3_kernel.REPLACES, hash_err,
        t["hash"], t["hash_plain"])
    return rows


def same_tree(a: str, b: str) -> int:
    """Raise unless the trees under a and b hold the same files and
    directories with the same bytes; returns the file count."""
    def listing(root):
        out = set()
        for d, dirs, files in os.walk(root):
            rel = os.path.relpath(d, root)
            out.update(os.path.normpath(os.path.join(rel, x)) + "/"
                       for x in dirs)
            out.update(os.path.normpath(os.path.join(rel, x)) for x in files)
        return out
    la, lb = listing(a), listing(b)
    if la != lb:
        raise AssertionError(f"trees differ: {sorted(la ^ lb)[:10]}")
    files = [p for p in la if not p.endswith("/")]
    for p in files:
        if not filecmp.cmp(os.path.join(a, p), os.path.join(b, p),
                           shallow=False):
            raise AssertionError(f"file differs after downsync: {p}")
    return len(files)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gib", type=float, default=1.0,
                    help="size of the synthetic asset tree in GiB")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from longtail_tpu_torch import _host, _kernels, api
    from longtail_tpu_torch.core.indexing import create_version_index
    from longtail_tpu_torch.ops import blake3_kernel
    from longtail_tpu_torch.parallel import pipeline, stage1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)                                  # card name, power limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _kernels.load()
    log(f"build: {time.perf_counter() - t0:.2f} s ({_kernels.LIB_PATH})")

    # 3. kernels against their plain versions
    rows = check_kernels(args.seed)

    # 4. main path
    C = _host.constants
    tmp = tempfile.mkdtemp(prefix="lt_chip_smoke_")
    try:
        src = os.path.join(tmp, "src")
        total = make_tree(src, int(args.gib * (1 << 30)), args.seed)
        log(f"tree: {total} bytes under {src}")
        fs = _host.FSStorage()
        store_dir = os.path.join(tmp, "store")
        wrappers = {"scan": stage1.scan, "walk": stage1.walk,
                    "pack": pipeline.pack,
                    "blake3": blake3_kernel.hash_chunks_words_device}
        for w in wrappers.values():
            w.LAUNCHES = 0
        stage1.repair_lane.REPAIRS = 0
        store = _host.CompressBlockStore(_host.FSBlockStore(fs, store_dir))
        t0 = time.perf_counter()
        vi, _ = api.upsync(fs, src, store, device=torch.device("cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.LAUNCHES for k, w in wrappers.items()}
        log(f"upsync: {vi.asset_count} assets, {vi.chunk_count} chunks, "
            f"{wall:.3f} s, {total / wall / 1e9:.3f} GB/s "
            f"(chunk+hash on the card, LZ4 blocks on the host)")
        log(f"launches in the main path: {launches}; ambiguous lanes "
            f"repaired on the host: {stage1.repair_lane.REPAIRS}")
        for k, v in launches.items():
            if v <= 0:
                raise AssertionError(f"the main path never launched {k}")
        for r in rows:
            r["launches"] = launches[r["name"]]

        # 5. held to the host (and a second device run, timed alone)
        infos = _host.host_indexing.get_files_recursively(fs, src)
        tags = np.full(infos.count, C.COMPRESSION_TYPE_LZ4_DEFAULT, np.uint32)
        t0 = time.perf_counter()
        vi_dev = create_version_index(fs, src, infos, asset_tags=tags,
                                      workers=8, device=torch.device("cuda"))
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        vi_host = _host.host_indexing.create_version_index(
            fs, src, infos, C.HASH_TYPE_BLAKE3, C.DEFAULT_TARGET_CHUNK_SIZE,
            asset_tags=tags, workers=8, xp=np)
        t_host = time.perf_counter() - t0
        log(f"index only: device {t_dev:.3f} s "
            f"({total / t_dev / 1e9:.3f} GB/s), host native {t_host:.3f} s "
            f"({total / t_host / 1e9:.3f} GB/s)")
        if vi.to_bytes() != vi_host.to_bytes():
            raise AssertionError(".lvi differs from the host path's")
        if vi_dev.to_bytes() != vi.to_bytes():
            raise AssertionError("a second device index differs")
        log(f".lvi: byte-identical to the host path "
            f"({len(vi.to_bytes())} bytes)")
        out = os.path.join(tmp, "out")
        _host.host_api.downsync(
            _host.CompressBlockStore(_host.FSBlockStore(fs, store_dir)), fs,
            out, vi, min_block_usage_percent=0)
        log(f"downsync: {same_tree(src, out)} files byte-identical")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
