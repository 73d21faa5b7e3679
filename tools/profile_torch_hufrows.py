#!/usr/bin/env python3
"""What holds the Huffman pack's (S, n_pad) rows kernel back, on one card.

    python3 tools/profile_torch_hufrows.py [--rounds 2] [--out rows.json]

It builds csrc/hufpack.cu three times: as the library builds it, with
LT_VARIANT_NO_LENGTHS (each literal taken as 5 bits, no table lookup in
the code-length scan) and with LT_VARIANT_NO_PACK (no code packed), and
times each build's rows kernel, one launch a call, on chip_smoke.py's
first two rows cases (device_entropy's 128 x 128 KiB and 2 ragged x 1
MiB) by CUDA events behind a spin (chip_smoke.spin_ms, 20 calls), every
case once per round, the rounds in turn.  The variant builds compute
wrong words; only their times are of use.  Prints one JSON line with
the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from longtail_tpu_torch import _kernels  # noqa: E402
from longtail_tpu_torch.ops import entropy_kernel as ek  # noqa: E402

VARIANTS = {"kernel": [], "no length lookups": ["-DLT_VARIANT_NO_LENGTHS"],
            "no pack": ["-DLT_VARIANT_NO_PACK"]}


def build_variants() -> dict:
    """{variant: its build's lt_hufpack_rows}, one nvcc per build, all
    started together."""
    nvcc = _kernels.find_nvcc()
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(_kernels.CSRC, "hufpack.cu")
    jobs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        so = os.path.join(_kernels.BUILD_DIR, f"variant_hufrows_{i}.so")
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, *_kernels.defines(), *flags,
             "-shared", src, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc of variant {name}: {err[-4000:]}")
        fn = ctypes.CDLL(so).lt_hufpack_rows
        fn.argtypes = _kernels._SIGNATURES["lt_hufpack_rows"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_hufrows: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    fns = build_variants()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = chip_smoke.hufpack_rows_cases(np.random.default_rng(7), dev)[:2]
    times = {name: {v: [] for v in fns} for name, _ in cases}
    for _ in range(args.rounds):
        for name, (lits, n_lit, table) in cases:
            S, n_pad = lits.shape
            W = ek.words_per_stream(n_pad)
            P = S * ek.pieces_per_row(n_pad)
            tickets = P + S * -(-W // ek.ZERO_WORDS)
            words = torch.empty((S, W), dtype=torch.int32, device=dev)
            totals = torch.empty((S,), dtype=torch.int32, device=dev)
            for v, fn in fns.items():
                work = torch.zeros((ek.rows_work_words(P),),
                                   dtype=torch.int64, device=dev)
                calls = [0]

                def call():
                    rc = fn(lits.data_ptr(), n_lit.data_ptr(),
                            table.data_ptr(), words.data_ptr(),
                            totals.data_ptr(), work.data_ptr(), S, n_pad, W,
                            ek.ZERO_WORDS, calls[0] + 1,
                            calls[0] * tickets & 0xFFFFFFFF, stream)
                    _kernels.check(rc, "lt_hufpack_rows")
                    calls[0] += 1

                times[name][v].append(chip_smoke.spin_ms(call, 20))
    result = {"device": smi, "ms": times}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
