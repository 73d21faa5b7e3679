#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's upsync --device goes with the
device codecs, on one card: per-step host timers summed over the writer
threads for a warm zstd and LZ4 upsync of chip_smoke.py's synthetic tree,
the device's busy share and largest device items under torch.profiler,
and the per-step times of a BLAKE2 upsync of a smaller tree.

    python3 tools/profile_torch_codecs.py [--gib 1.0] [--blake2-gib 0.03125]
                                          [--out steps.json]
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
timed(device_entropy, "device_histogram", "zstd frame: histogram (device)")
timed(zstd_frame, "build_huffman", "zstd frame: build_huffman (host)")
timed(device_entropy, "_pack_streams_device", "zstd frame: hufpack + copies")
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--blake2-gib", type=float, default=1 / 32)
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_codecs: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    _kernels.load()
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
