#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's upsync --device goes with the
device codecs, on one card: per-step host timers summed over the writer
threads for a warm zstd and LZ4 upsync of chip_smoke.py's synthetic tree,
the device's busy share and largest device items under torch.profiler,
and the per-step times of a BLAKE2 upsync of a smaller tree.

    python3 tools/profile_torch_codecs.py [--gib 1.0] [--blake2-gib 0.03125]
                                          [--out steps.json]

With --kernel-variants [--rounds 3] it instead asks what holds the scan
and BLAKE3 kernels back: it builds csrc/stage1.cu and csrc/blake3.cu
with the -D switches that remove one part of the work (the global loads,
the shared lookups or the tree merge replaced by register arithmetic,
the table fill skipped, fewer blocks per SM, the scan's candidate filter
on d's odd part), and times each build's kernel on one 64 MiB batch of
the structured data beside the kernel's own, the scan's two filters
also at the 1 KiB target's discriminator, each case once per round.  The
variant builds compute wrong results; only their times are of use.
"""
import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from longtail_tpu_torch import _kernels, api  # noqa: E402
from longtail_tpu_torch.core import indexing  # noqa: E402
from longtail_tpu_torch.formats import constants as C  # noqa: E402
from longtail_tpu_torch.ops import (  # noqa: E402
    device_entropy,
    lz4,
    zstd_device,
    zstd_frame,
)
from longtail_tpu_torch.parallel import device_lz4  # noqa: E402
from longtail_tpu_torch.stores import compressblockstore  # noqa: E402
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore  # noqa: E402
from longtail_tpu_torch.stores.storage import FSStorage  # noqa: E402

ACC = collections.defaultdict(float)
CNT = collections.Counter()
LOCK = threading.Lock()


def timed(mod, name, label):
    f = getattr(mod, name)

    def g(*a, **k):
        t = time.perf_counter()
        try:
            return f(*a, **k)
        finally:
            dt = time.perf_counter() - t
            with LOCK:
                ACC[label] += dt
                CNT[label] += 1
    setattr(mod, name, g)


timed(api, "create_version_index", "index (create_version_index)")
timed(api, "write_content", "write_content (wall)")
timed(compressblockstore, "compress_block", "compress_block (thread sum)")
timed(zstd_device, "fast_block_anchors", "zstd: anchors (device sorts, copies)")
timed(zstd_device, "sequences_from_anchors", "zstd: native sequence walk")
timed(zstd_device, "frame_from_sequences", "zstd: frame assembly")
timed(device_entropy, "device_histograms",
      "zstd frame: histograms (device, one call a frame)")
timed(zstd_frame, "build_huffman", "zstd frame: build_huffman (host)")
timed(device_entropy, "pack_streams",
      "zstd frame: hufpack + copies (one launch a frame)")
timed(zstd_frame, "_encode_sequences",
      "zstd frame: _encode_sequences (host)")
timed(device_lz4, "block_anchors", "lz4: anchors (device sorts, copies)")
timed(lz4, "assemble_anchors", "lz4: native assembly")
timed(indexing, "_chunk_one_asset", "small files (host path)")
timed(indexing, "assemble_chunked_assets",
      "assemble_chunked_assets (content hashes)")


def busy_ms(prof):
    """Union of the device intervals (kernels, copies, memsets) in ms."""
    iv = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            iv.append((e.time_range.start, e.time_range.end))
    iv.sort()
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


# the variant builds of the scan and BLAKE3 kernels: the -D switches of
# csrc/stage1.cu and csrc/blake3.cu, each removing one part of the work
# (the odd-part filter keeps the scan's results and changes its filter)
VARIANTS = {
    "scan": ("stage1.cu", "lt_stage1_scan", "scan_kernel", {
        "kernel": [],
        "no global loads": ["-DLT_VARIANT_NO_LOADS"],
        "no shared lookups": ["-DLT_VARIANT_NO_LOOKUPS"],
        "no table fill": ["-DLT_VARIANT_NO_FILL"],
        "2 blocks per SM": ["-DLT_SCAN_BLOCKS_PER_SM=2"],
        "odd-part filter": ["-DLT_VARIANT_ODD_FILTER"]}),
    "blake3": ("blake3.cu", "lt_blake3", "blake3_kernel", {
        "kernel": [],
        "no global loads": ["-DLT_VARIANT_NO_LOADS"],
        "no tree merge": ["-DLT_VARIANT_NO_MERGE"]}),
}


def build_variants() -> dict:
    """{(kernel, variant): the bound entry point of its build}, one nvcc
    per build, all started together."""
    import ctypes

    nvcc = _kernels.find_nvcc()
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    jobs = {}
    for kname, (src, entry, _, builds) in VARIANTS.items():
        for i, (vname, flags) in enumerate(builds.items()):
            so = os.path.join(_kernels.BUILD_DIR, f"variant_{kname}_{i}.so")
            jobs[kname, vname] = (so, entry, subprocess.Popen(
                [nvcc, *_kernels.NVCC_FLAGS, *_kernels.defines(), *flags,
                 "-shared", os.path.join(_kernels.CSRC, src), "-o", so],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for key, (so, entry, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant {key}: {err[-4000:]}")
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = _kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def kernel_variants(rounds: int) -> dict:
    """Device ms of the scan and BLAKE3 kernels and of their variant
    builds on one 64 MiB batch (2 x 32 MiB parts, the batch's chunks) at
    the default target (d 12318), and of the scan and its odd-part filter
    build at the 1 KiB target (d 384); every case is timed once per
    round, the rounds in turn, and reported as min, median and max."""
    from longtail_tpu_torch.ops import blake3
    from longtail_tpu_torch.parallel import stage1
    from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig

    dev = torch.device("cuda")
    P = 32 << 20
    cfg = ChunkerConfig.from_target(32768)
    plan = stage1.Stage1Plan(cfg, 2, P)
    batch = torch.from_numpy(chip_smoke.structured(
        np.random.default_rng(7), 2 * P)).to(dev)
    lens = torch.tensor([P, P], dtype=torch.int32, device=dev)
    table = stage1.hash_table(dev)
    summ = stage1.scan(batch, lens, table, plan)
    sizes, n, _ = stage1.unpack_walk(
        stage1.walk(lens, *summ, plan).cpu().numpy(), plan)
    sz = np.concatenate([sizes[b, :n[b]] for b in range(2)]).astype(np.int64)
    st = np.concatenate([b * P + np.cumsum(sizes[b, :n[b]].astype(np.int64))
                         - sizes[b, :n[b]] for b in range(2)])
    st_t, sz_t = (torch.from_numpy(x.astype(np.int32)).to(dev)
                  for x in (st, sz))
    plan_t = torch.from_numpy(blake3.plan_blocks(blake3.leaves_of(sz))).to(dev)
    out = torch.empty((3, batch.numel() // 128), dtype=torch.int32,
                      device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def scan_args(c):
        z = stage1.segment_bytes(c)
        return (batch.data_ptr(), lens.data_ptr(), table.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                None, batch.numel(), P, z.bit_length() - 1,
                *stage1.scan_constants(c.discriminator), stream)

    fns = build_variants()
    cases = {f"{k}: {v}": (fns[k, v], VARIANTS[k][2],
                           scan_args(cfg) if k == "scan" else
                           (batch.data_ptr(), batch.numel(), st_t.data_ptr(),
                            sz_t.data_ptr(), plan_t.data_ptr(),
                            out.data_ptr(), len(sz), plan_t.numel() - 1,
                            stream))
             for k, v in fns}
    small = scan_args(ChunkerConfig.from_target(1024))
    for v in ("kernel", "odd-part filter"):
        cases[f"scan at d 384: {v}"] = (fns["scan", v], "scan_kernel", small)
    res = {k: [] for k in cases}
    for r in range(rounds):
        for name, (fn, kernel, args) in cases.items():
            res[name].append(chip_smoke.device_ms(
                lambda: _kernels.check(fn(*args), name), 20, kernel))
        print(f"round {r + 1} of {rounds} done", flush=True)
    for name, ms in res.items():
        print(f"{name}: min {min(ms):.4f}, median {float(np.median(ms)):.4f},"
              f" max {max(ms):.4f} ms of device time over {rounds} rounds",
              flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--blake2-gib", type=float, default=1 / 32)
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    ap.add_argument("--kernel-variants", action="store_true",
                    help="time variants of the scan and BLAKE3 kernels")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of --kernel-variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_codecs: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    _kernels.load()
    if args.kernel_variants:
        out = kernel_variants(args.rounds)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    dev = torch.device("cuda")
    fs = FSStorage()
    tmp = tempfile.mkdtemp(prefix="lt_profile_")
    out = {}
    try:
        src = os.path.join(tmp, "src")
        total = chip_smoke.make_tree(src, int(args.gib * (1 << 30)), 7)
        src_b2 = os.path.join(tmp, "src_b2")
        total_b2 = chip_smoke.make_tree(src_b2, int(args.blake2_gib * (1 << 30)), 7)
        k = 0

        def upsync(tree, tag, hash_id=C.HASH_TYPE_BLAKE3):
            nonlocal k
            k += 1
            store = compressblockstore.CompressBlockStore(FSBlockStore(
                fs, os.path.join(tmp, f"store{k}")), device=dev)
            t0 = time.perf_counter()
            api.upsync(fs, tree, store, compression_tag=tag,
                       hash_identifier=hash_id, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for name, tag in (("zstd", C.COMPRESSION_TYPE_ZSTD_DEFAULT),
                          ("lz4", C.COMPRESSION_TYPE_LZ4_DEFAULT)):
            cold = upsync(src, tag)
            ACC.clear()
            CNT.clear()
            warm = upsync(src, tag)
            steps = {k2: [round(v, 4), CNT[k2]] for k2, v in
                     sorted(ACC.items(), key=lambda x: -x[1])}
            print(f"{name}: upsync cold {cold:.3f} s, warm {warm:.3f} s = "
                  f"{total / warm / 1e9:.4f} GB/s", flush=True)
            for k2, v in steps.items():
                print(f"  {k2}: {v[0]:.3f} s over {v[1]} calls "
                      f"({100 * v[0] / warm:.1f}% of the wall)", flush=True)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                wall = upsync(src, tag)
            try:
                busy = busy_ms(prof)
                ka = prof.key_averages()
                top = sorted(((e.key, e.device_time_total / 1e3, e.count)
                              for e in ka), key=lambda x: -x[1])[:12]
            except Exception:
                import traceback
                traceback.print_exc()
                busy, top = float("nan"), []
            print(f"{name}: profiled upsync {wall:.3f} s, device busy "
                  f"{busy:.1f} ms = {100 * busy / 1e3 / wall:.2f}% of the wall",
                  flush=True)
            for key, ms, n in top:
                print(f"  {key[:70]}: {ms:.2f} ms, {n} calls", flush=True)
            out[name] = {"cold_s": cold, "warm_s": warm, "steps": steps,
                         "profiled_s": wall, "busy_ms": busy,
                         "top_device": top}

        ACC.clear()
        CNT.clear()
        wall = upsync(src_b2, C.COMPRESSION_TYPE_ZSTD_DEFAULT,
                      C.HASH_TYPE_BLAKE2)
        steps = {k2: [round(v, 4), CNT[k2]] for k2, v in
                 sorted(ACC.items(), key=lambda x: -x[1])}
        print(f"blake2: upsync {wall:.3f} s of {total_b2} bytes", flush=True)
        for k2, v in steps.items():
            print(f"  {k2}: {v[0]:.3f} s over {v[1]} calls", flush=True)
        out["blake2"] = {"wall_s": wall, "steps": steps}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
