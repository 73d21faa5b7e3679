#!/usr/bin/env python3
"""Where the peak RSS of bench_torch.py's downsync child goes: the same
upsync (a synthetic tree from bench_torch.make_corpus, zstd, on the
device) and the same CLI child, whose /proc status is sampled every
50 ms for VmRSS and its anonymous and file-backed parts, beside a child
that only imports the port's CLI and one that also initialises CUDA.

    python3 tools/downsync_rss.py [--gib 0.25] [--device cuda]

Prints one JSON object: per child, its peak VmRSS, RssAnon and RssFile
in GiB and its wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from longtail_tpu_torch import api  # noqa: E402
from longtail_tpu_torch.formats import constants as C  # noqa: E402
from longtail_tpu_torch.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore,
)
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore  # noqa: E402
from longtail_tpu_torch.stores.storage import FSStorage  # noqa: E402

FIELDS = ("VmRSS", "RssAnon", "RssFile")


def peak_rss(argv) -> dict:
    """Run argv from the repository's root; its peaks of FIELDS in GiB
    (None for a field the kernel does not report) and its wall seconds.
    Raises if it exits non-zero."""
    t0 = time.perf_counter()
    child = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
    peak = dict.fromkeys(FIELDS)
    try:
        while child.poll() is None:
            try:
                with open(f"/proc/{child.pid}/status") as f:
                    for ln in f:
                        k = ln.split(":")[0]
                        if k in peak:
                            peak[k] = max(peak[k] or 0, int(ln.split()[1]))
            except FileNotFoundError:
                break
            time.sleep(0.05)
        err = child.communicate()[1]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f"{argv} exited {child.returncode}: "
                           f"{err[-2000:].decode(errors='replace')}")
    out = {k: None if v is None else round(v / 1048576, 3)
           for k, v in peak.items()}
    out["wall_s"] = round(time.perf_counter() - t0, 3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gib", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    total = int(args.gib * 2**30)
    base = tempfile.mkdtemp(prefix="lt_rss_")
    try:
        src = os.path.join(base, "src")
        os.makedirs(src)
        for i, part in bench_torch.parts_of(bench_torch.make_corpus(total),
                                            bench_torch.DOWNSYNC_FILE_BYTES):
            part.tofile(os.path.join(src, f"f{i >> 26:04d}.bin"))
        fs = FSStorage()
        store = os.path.join(base, "store")
        vi, _ = api.upsync(
            fs, src, CompressBlockStore(FSBlockStore(fs, store),
                                        device=args.device),
            compression_tag=C.COMPRESSION_TYPE_ZSTD_DEFAULT, workers=8,
            device=args.device)
        lvi = os.path.join(base, "v.lvi")
        with open(lvi, "wb") as f:
            f.write(vi.to_bytes())
        py = sys.executable
        res = {"device": bench_torch.device_info(args.device)}
        res["import the CLI"] = peak_rss(
            [py, "-c", "import longtail_tpu_torch.cli"])
        res["import the CLI, init CUDA"] = peak_rss(
            [py, "-c", "import longtail_tpu_torch.cli, torch; "
             "torch.cuda.init() if torch.cuda.is_available() else None"])
        for w in ("8", "1"):
            res[f"downsync --workers {w}"] = peak_rss(
                [py, "-m", "longtail_tpu_torch.cli", "--workers", w,
                 "downsync", "--storage-uri", store, "--source-path", lvi,
                 "--target-path", os.path.join(base, f"out{w}")])
        print(json.dumps(res))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
