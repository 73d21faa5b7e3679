"""The control of the comparison that decides ``correct``: the reference
put in the program's place with one guarantee of the configuration
broken, judged as a run's outputs are.  It has to come out not correct.

    python3 -m ltbench.control --workload <cell> --seeds 1 2 3
                               [--device cuda|cpu] [--tiny]

- An upsync cell: the version index is the reference's own, made with
  every chunk hash cut to 32 bits (the next width below the 64-bit hash
  that content addressing rests on).  Its store is not made, so only
  the .lvi is compared.
- A downsync cell: the client folder is patched by the reference, which
  rewrites only the files whose size changed (a shortcut that skips
  re-indexing the target).

The benchmark's own runs never run this.  One line per seed: the numbers
compared, and whether the control came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys


def size_only_patch(before: dict, after: dict) -> tuple[dict, set]:
    """The client folder after a patch from before to after that writes
    only files that are new or whose size changed."""
    from ltbench.reference.target import folders

    files = {}
    for path, data in after.items():
        old = before.get(path)
        keep = old is not None and len(old) == len(data)
        files[path] = (old if keep else data).tobytes()
    return files, folders(after)


def control(workload: str, seed: int, device: str, tiny: bool) -> dict:
    import torch

    from ltbench import run as run_mod
    from ltbench import tree as tree_mod
    from ltbench.reference import index, target

    found = run_mod.find_cell(run_mod.load_json("BENCHMARK.json"), workload)
    cfg, traffic = found["cfg"], dict(found["traffic"])
    spec = dict(run_mod.TINY if tiny else cfg["tree"])
    if "patch" in traffic:
        spec["patch"] = run_mod.TINY_PATCH if tiny else traffic["patch"]
    a, patch = tree_mod.make(spec, seed, torch.device(device))
    b = tree_mod.apply(a, patch) if "patch" in traffic else None
    if traffic["job"] == "upsync":
        want = a if traffic["store"] == "empty" else b
        ref = index.build(want, cfg, device)
        low = index.build(want, cfg, device, hash_bits=32)
        return {"lvi_bytes_differing": index.bytes_differing(low.lvi,
                                                             ref.lvi)}
    files, dirs = size_only_patch(a, b)
    return target.check_target(files, dirs, b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ltbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        checks = control(args.workload, seed, args.device, args.tiny)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(v <= 0 for v in checks.values()),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
