"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 -m ltbench.run --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1> [--device cuda|cpu] [--tiny]

The cell, its configuration and its traffic are found by name from
``BENCHMARK.json`` (``ltbench/configs/<config>.json``,
``ltbench/traffic/<traffic>.json``), and each per-layer metric by its own
reader, ``ltbench/metrics/<metric>.py``.  Set-up makes the tree from the
seed, does what the traffic needs before its first job and runs one
whole job untimed; the window then runs jobs one at a time until
``--seconds`` of the program's time have passed, and waits for the
last.  With ``--trace 1``
spans and counters are kept through the window, one more job runs under
``torch.profiler``, and the result carries the per-layer metrics in
place of the end-to-end ones.  Once the window has closed the reference
(``ltbench/reference``) judges what the jobs produced.

``--device cpu --tiny`` is a rehearsal on the CPU: the kernels' plain
versions over a small tree.  Its result says ``"platform": "cpu"`` and
carries no device metric.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

ROOT = os.getcwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "longtail_tpu")
# a small tree with the configured tree's structure, for rehearsals
TINY = {"paks_mib": [0.75, 1, 1.25, 1.5, 2], "pak_ragged_mib": 0.25,
        "exact_mib": 1, "loose_files": 24, "loose_min_kib": 1,
        "loose_max_kib": 512, "empty_files": 1, "piece_mib": 0.5,
        "mix": {"text": 3, "zeros": 1, "tile": 1, "noise": 3},
        "tile_kib": 24, "vocabulary": 512, "zipf": 1.1}
TINY_PATCH = {"pak_share": 0.06, "span_min_kib": 16, "span_max_kib": 64,
              "loose_replaced": 3, "loose_added": 2, "loose_removed": 2}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    """The cell, its configuration, traffic, end-to-end metrics and
    per-layer metrics, all by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"ltbench: no workload named {name!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(configs[cell["config"]]["file"])
    traffic = load_json(f"ltbench/traffic/{cell['traffic']}.json")

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and ("workloads" in m or m["moves"] in names)]
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "e2e": e2e,
            "per_layer": layer}


def reader(metric: str):
    """The read(ctx) function of ltbench/metrics/<metric>.py."""
    path = os.path.join(ROOT, "ltbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "ltbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(kept, final, cfg, traffic, device) -> tuple[dict, dict]:
    """(the numbers compared, facts such as the stored ratio)."""
    from ltbench import jobs as jobs_mod
    from ltbench.reference import blocks, index, target

    checks: dict = {}
    facts: dict = {}

    def add(d):
        for k, v in d.items():
            checks[k] = checks.get(k, 0) + int(v)

    def show(k, detail):
        for path, why in detail[:10]:
            log(f"ltbench: job {k}: {path}: {why}")

    if traffic["job"] == "upsync":
        t = time.perf_counter()
        want = kept[0][3]
        ref = index.build(want, cfg, device)
        facts["reference_index_s"] = time.perf_counter() - t
        add({"lvi_bytes_differing": sum(
            index.bytes_differing(lvi, ref.lvi)
            for lvi in {o[1] for o in kept})})
        judged, verdicts = {}, {}
        for k, _, held, _, key in kept:
            lsi = held.get(f"{jobs_mod.STORE}/store.lsi")
            if key in judged:
                add({"lsi_entries_differing": blocks.lsi_differing(
                    lsi, judged[key])})
                continue
            detail = []
            nums, stored = blocks.check_store(
                held, ref, cfg, fresh=traffic["store"] == "empty",
                detail=detail, verdicts=verdicts)
            show(k, detail)
            judged[key] = lsi
            add(nums)
            facts.setdefault("stored_bytes", stored)
            facts.setdefault("source_bytes", ref.source_bytes)
        facts["stores_judged"] = len(judged)
    else:
        # every job's client folder by its files' digests, and the last
        # one byte by byte
        want_digests = {}
        for k, _, (got, dirs), want, _ in kept:
            if id(want) not in want_digests:
                want_digests[id(want)] = target.digests(want)
            detail = []
            add(target.check_digests(got, dirs, want, want_digests[id(want)],
                                     detail))
            show(k, detail)
        k, (files, dirs), want = final
        detail = []
        add(target.check_target(files, dirs, want, detail))
        show(k, detail)
    return checks, facts


def usage() -> tuple:
    """(user, system) CPU seconds of this process so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime


def rss_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ltbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a small tree with the same structure "
                         "(rehearsals)")
    args = ap.parse_args(argv)

    bench = load_json("BENCHMARK.json")
    found = find_cell(bench, args.workload)
    cell, cfg, traffic = found["cell"], found["cfg"], dict(found["traffic"])

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            log(f"ltbench: the cell needs {cell['chips']} CUDA device(s); "
                f"torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, device_count() "
                f"{torch.cuda.device_count()}")
            return 2
    spec = None
    if args.tiny:
        spec = TINY
        if "patch" in traffic:
            traffic["patch"] = TINY_PATCH

    from longtail_tpu_torch import api

    from ltbench import jobs as jobs_mod
    from ltbench import spans, trace

    scratch = tempfile.mkdtemp(prefix="ltbench-")
    record = spans.Recorder(profile=bool(args.trace)) if args.trace \
        else None
    try:
        run = jobs_mod.Jobs(cfg, traffic, args.seed, args.device, scratch,
                            record, spec)
        if args.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if record is not None:
            record.install(api)
        run.setup()
        # one whole job warms every shape, the heap and the caches at
        # the window's own sizes: set-up, not measured (its output is
        # judged with the window's)
        run.keep(0, run.job(0))
        if record is not None:
            record.clear()
        setup_s = time.perf_counter() - T0

        # the window: jobs one at a time until --seconds of the program's
        # time have passed.  Its rate is over the wall from the first
        # start to the last end, less only the harness's own measured
        # work between jobs (restoring a store, keeping outputs), so every
        # stall of the program counts.
        done, notes, failed = [], [], 0
        harness = 0.0
        t_start = time.perf_counter()
        k = 1
        while True:
            h = time.perf_counter()
            run.before(k)
            u0 = usage()
            t0 = time.perf_counter()
            harness += t0 - h
            try:
                out = run.job(k)
                if args.device == "cuda":
                    torch.cuda.synchronize()
            except Exception:
                log(traceback.format_exc())
                failed += 1
                t_end = time.perf_counter()
                break
            t_end = time.perf_counter()
            u1 = usage()
            done.append((t0, t_end, run.source_bytes(k)))
            notes.append((t_end - t0, u1[0] - u0[0], u1[1] - u0[1],
                          rss_mib()))
            if t_end - t_start - harness >= args.seconds:
                break
            run.keep(k, out)
            del out
            harness += time.perf_counter() - t_end
            k += 1
        program_s = t_end - t_start - harness
        last = k
        if not failed:
            run.keep(last, out)
            del out
        attempted = len(done) + failed
        window_spans = list(record.spans) if record else []
        counters = dict(record.counters) if record else {}

        prof = None
        if args.trace and args.device == "cuda" and not failed:
            for _ in range(3):
                last += 1
                run.before(last)
                out, prof = trace.profile(lambda: run.job(last), record)
                run.keep(last, out)
                del out
                if prof is not None:
                    break
                log("ltbench: the profiler recorded no device operation; "
                    "profiling one more job")
        if args.device == "cuda":
            peak = int(torch.cuda.max_memory_allocated())
            kind = torch.cuda.get_device_name(0)
        else:
            peak, kind = 0, "cpu"
        if record is not None:
            record.uninstall()
        bad = forbidden_modules()
        if bad:
            log(f"ltbench: modules of {bad} are loaded after the window: "
                "the benchmark runs the PyTorch port alone")
            return 3

        # the program's outputs as bytes; then its state goes
        kept = run.results()
        final = (last, run.final(), run.b if last % 2 == 0 else run.a) \
            if traffic["job"] == "downsync" else None
        lvi_last = next((o[1] for o in reversed(kept) if o[1] is not None),
                        None)
        run.release()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        checks, facts = judge(kept, final, cfg, traffic, args.device)
        facts["reference_s"] = time.perf_counter() - t_ref
        checks["jobs_failed"] = failed
        checks["jobs_missing"] = int(attempted == 0)
        correct = all(v <= 0 for v in checks.values())

        rate = sum(b for _, _, b in done) / program_s / 1e9 \
            if done else None
        ratio = facts["source_bytes"] / facts["stored_bytes"] \
            if facts.get("stored_bytes") else None
        metrics = {}
        if not args.trace:
            for m in found["e2e"]:
                # every *_gbps metric is the cell's job rate
                v = {"setup_s": setup_s, "stored_ratio": ratio}.get(
                    m["name"], rate if m["name"].endswith("_gbps") else None)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        # what a per-layer metric's reader reads
        ctx = types.SimpleNamespace(jobs=done, spans=window_spans, counters=counters,
                      trace=prof, lvi=lvi_last, cfg=cfg, traffic=traffic,
                      cell=cell, platform="gpu" if args.device == "cuda"
                      else "cpu")
        if args.trace:
            for m in found["per_layer"]:
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        device = {"platform": "gpu" if args.device == "cuda" else "cpu",
                  "kind": kind, "count": int(cell["chips"]),
                  "memory_peak_bytes": peak}
        if prof is not None:
            device["busy_s"] = prof.busy_s
            device["window_s"] = prof.window_s
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": device}
        if args.device == "cpu":
            result["rehearsal"] = "CPU run: no device measurement"
        if prof is not None:
            top = sorted(prof.by_name.items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[label, s] for s, label in prof.gaps[:10]]}
        result["checks"] = {n: {"value": v, "limit": 0}
                            for n, v in checks.items()}
        log(f"ltbench: setup_s {setup_s:.3f}; window {program_s:.3f} s "
            f"of the program, {harness:.3f} s of the harness; per job: "
            "wall s/user s/system s/RSS MiB " + ", ".join(
                "/".join(f"{v:.3f}" for v in n) for n in notes)
            + f"; reference {facts['reference_s']:.3f} s; "
            + ", ".join(f"{k} {v}" for k, v in facts.items()
                        if k != "reference_s"))
        if forbidden_modules():
            log(f"ltbench: modules of {forbidden_modules()} are loaded")
            return 3
        for n, v in checks.items():
            log(f"check {n} {v} limit 0")
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
