#!/usr/bin/env python3
"""The cost on the card of two steps that bench_torch.py keeps from
bench.py, whose reasons were the TPU development rig's: 256 MiB batches
and a warm-up of at least 8 batches.  (The third, the per-batch
perturbation, is timed alone in the log of every data-plane run.)

    python3 tools/bench_rig_steps.py [--gib 1.0] [--rounds 2] [--device cuda]

Runs bench_torch's chunk_hash_compress and chunk_hash, without the
verification, in three variants: as bench.py sets them (256 MiB batches,
8 warm-up batches), with 64 MiB batches (DevicePartIndexer's default)
and with a warm-up of 1 batch.  The variants run in turns, forward then
backward in each round, all in one process on one card.  Prints one JSON
object: per mode and variant, the values and each call's wall seconds
(warm-up and the zstd context included).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench_torch  # noqa: E402

VARIANTS = {  # name: keyword arguments of bench_torch.bench_data_plane
    "bench.py's (256 MiB, 8 warm-up)": {"batch_mib": 256},
    "64 MiB batches": {"batch_mib": 64},
    "1 warm-up batch": {"batch_mib": 256, "warmup_batches": 1},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    total = int(args.gib * 2**30)
    out = {"device": bench_torch.device_info(args.device)}
    for mode in ("chunk_hash_compress", "chunk_hash"):
        runs = {v: {"value": [], "wall_s": []} for v in VARIANTS}
        order = list(VARIANTS)
        for r in range(args.rounds):
            for v in order if r % 2 == 0 else order[::-1]:
                t0 = time.perf_counter()
                res = bench_torch.bench_data_plane(
                    total, 32768, mode == "chunk_hash_compress",
                    args.device, verify=False, **VARIANTS[v])
                runs[v]["wall_s"].append(time.perf_counter() - t0)
                runs[v]["value"].append(res["value"])
                bench_torch.log(f"{mode} [{v}]: {res}")
        out[mode] = runs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
