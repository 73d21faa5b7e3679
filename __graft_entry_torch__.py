"""Driver entry points of the PyTorch/CUDA port: the counterpart of
``__graft_entry__.py``, on ``longtail_tpu_torch``.

- ``entry(device="cuda")``: one step of the chunk+hash data plane over
  tensors on one device (the stage-1 scan and walk kernels, the pack
  kernel and the BLAKE3 kernel), with its example arguments.
- ``dryrun_multichip(n, device="cuda")``: the distributed legs on tiny
  shapes: the sharded index and chunk steps in ``n`` ranks of a
  ``torch.distributed`` group, a mesh upsync over ``n`` indexers against
  the single-device upsync, and a two-process upsync with a sharded
  downsync, each checked against its oracle.

Both run on the card unless asked for the CPU (``device="cpu"``: the
kernels' plain versions) and raise where there is no card.  Imports
torch, numpy and ``longtail_tpu_torch`` only.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

from longtail_tpu_torch.ops import blake3_kernel, pack
from longtail_tpu_torch.parallel import stage1
from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig
from longtail_tpu_torch.parallel.multihost import _launch_counts
from longtail_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.abspath(__file__))
TARGET = 1024
TIMEOUT = 600           # seconds a spawned rank or process may take


def _example_batch(lanes: int, part_bytes: int):
    rng = np.random.default_rng(42)
    parts = rng.integers(0, 256, size=(lanes, part_bytes), dtype=np.uint8)
    lengths = np.full((lanes,), part_bytes, dtype=np.int32)
    lengths[-1] = part_bytes - 137
    return parts, lengths


def _row_mult(cap: int) -> int:
    """The step's fixed slot count for rows of cap bytes: the JAX
    pipeline's row multiple (its BLAKE2 kernel tiles 256 rows, its BLAKE3
    kernel needs rows * leaves % 1024 == 0)."""
    return max(256, 1024 // max(cap // 1024, 1))


def _build_step(cfg: ChunkerConfig, lanes: int, part_bytes: int, device):
    """fn(batch, lengths) -> (sizes (lanes, c_pad) int32, n (lanes,)
    int32, lo, hi (rows,) int32): the chunk sizes (0 past a lane's count)
    and chunk counts of a flat (lanes * part_bytes,) uint8 batch, and the
    BLAKE3-64 words of lane 0's first chunks in ``rows`` fixed slots
    (slots past its count hold the digest of the empty input).  Ambiguous
    lanes are not repaired.  Every step runs on the batch's device."""
    plan = stage1.Stage1Plan(cfg, lanes, part_bytes)
    c_pad = plan.c_pad
    cap = pack.pow2_cap(cfg.padded_chunk)
    rows = _row_mult(cap)
    k = min(rows, c_pad)
    table = stage1.hash_table(device)
    idx = torch.arange(c_pad, dtype=torch.int32, device=device)

    def fn(batch, lengths):
        min1, min2, cnt = stage1.scan(batch, lengths, table, plan)
        out = stage1.walk(lengths, min1, min2, cnt, plan)
        ends, n = out[:, :c_pad], out[:, c_pad]
        starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
        sizes = torch.where(idx < n[:, None], ends - starts, 0)
        st0 = torch.zeros(rows, dtype=torch.int32, device=device)
        sz0 = torch.zeros_like(st0)
        st0[:k] = starts[0, :k]
        sz0[:k] = sizes[0, :k]
        lo, hi = blake3_kernel.hash_chunks_words_device(
            pack.pack(batch, st0, sz0, cap), sz0)
        return sizes, n, lo, hi

    return fn


def entry(device="cuda"):
    """(fn, example_args): the step of ``_build_step`` at the 1 KiB target
    over 8 lanes of 16 KiB (the last 137 bytes short), and its batch and
    lengths on ``device``."""
    dev = resolve_device(device)
    lanes, part_bytes = 8, 16384
    parts, lengths = _example_batch(lanes, part_bytes)
    batch = torch.empty(lanes * part_bytes, dtype=torch.uint8, device=dev)
    batch.copy_(torch.from_numpy(parts.reshape(-1)))
    fn = _build_step(ChunkerConfig.from_target(TARGET), lanes, part_bytes,
                     dev)
    return fn, (batch, torch.from_numpy(lengths).to(dev))


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(argvs, envs) -> list:
    """Run one process per (argv, env) from the repository root and wait
    for all, killing all on a timeout; raise with the output of any that
    failed, else return their outputs."""
    procs = [subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"process {r} exited {p.returncode}:\n"
                                 f"{out[-3000:]}")
    return outs


def _devices(n: int, kind: str) -> list:
    """Rank r's device: cuda:r on the card, else the CPU."""
    return [torch.device(kind, r) if kind == "cuda" else torch.device(kind)
            for r in range(n)]


def _sum(counts: list) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _sharded_batch(n: int):
    """The sharded legs' batch: 2 lanes a rank of 4 KiB, lane 0 one byte
    long, lane 1 min_size long."""
    parts, lengths = _example_batch(2 * n, 4096)
    lengths[0] = 1
    lengths[1] = ChunkerConfig.from_target(TARGET).min_size
    return parts, lengths


def _sharded_rank(addr: str, rank: str, n: str, kind: str, out: str) -> None:
    """One rank of the sharded legs: its two lanes through
    sharded_index_step and sharded_chunk_step in a group of gloo (CPU) or
    NCCL (CUDA) over tcp://addr; writes the unique hashes of both, the
    overflow count and its kernel launches to the JSON file out."""
    import torch.distributed as dist

    from longtail_tpu_torch.parallel import distributed

    rank, n = int(rank), int(n)
    dev = _devices(n, kind)[rank]
    if kind == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"tcp://{addr}", world_size=n,
                            rank=rank)
    try:
        cfg = ChunkerConfig.from_target(TARGET)
        parts, lengths = _sharded_batch(n)
        mine = slice(2 * rank, 2 * rank + 2)
        x = torch.from_numpy(parts[mine]).to(dev)
        *_, ulo, uhi, count = distributed.sharded_index_step(
            x, lengths[mine], cfg)
        slots = distributed.default_dedup_slots(cfg, 2, parts.shape[1])
        *_, ulo2, uhi2, count2, overflow = distributed.sharded_chunk_step(
            x, lengths[mine], cfg, slots)
        res = {"index": distributed.host_unique_hashes(ulo, uhi, count),
               "chunk": distributed.host_unique_hashes(ulo2, uhi2, count2)}
        with open(out, "w") as f:
            json.dump({**{k: [int(h) for h in v] for k, v in res.items()},
                       "overflow": int(overflow),
                       "launches": _launch_counts()}, f)
    finally:
        dist.destroy_process_group()


def _sharded_legs(n: int, kind: str, tmp: str) -> dict:
    """The sharded index and chunk steps in n spawned ranks; every rank's
    replicated unique set equals the host oracle (the port's chunk_part
    and hash64 per lane, globally sorted-unique).  Returns the ranks'
    launches, summed."""
    from longtail_tpu_torch.ops import blake3, cdc

    cfg = ChunkerConfig.from_target(TARGET)
    parts, lengths = _sharded_batch(n)
    want = []
    for b in range(2 * n):
        data = parts[b, :lengths[b]]
        ends = cdc.chunk_part(data, cfg.min_size, cfg.avg_size, cfg.max_size)
        starts = np.concatenate([[0], ends[:-1]])
        want += [blake3.hash64(data[s:e].tobytes())
                 for s, e in zip(starts, ends)]
    want = np.unique(np.array(want, dtype=np.uint64)).tolist()

    addr = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n)]
    code = ("import sys, __graft_entry_torch__ as g; "
            "g._sharded_rank(*sys.argv[1:])")
    env = dict(os.environ, PYTHONPATH=REPO)
    _run([[sys.executable, "-c", code, addr, str(r), str(n), kind, outs[r]]
          for r in range(n)], [env] * n)
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    for r, got in enumerate(ranks):
        for step in ("index", "chunk"):
            if got[step] != want:
                raise AssertionError(f"rank {r}: the {step} step's unique "
                                     "hashes differ from the host oracle")
        if got["overflow"]:
            raise AssertionError(f"rank {r}: sharded_chunk_step overflowed")
    return _sum([got["launches"] for got in ranks])


def _mesh_leg(n: int, dev: torch.device) -> tuple:
    """api.upsync of __graft_entry__.py's five-file tree over one indexer
    per rank device against the single-device upsync: the same .lvi and
    block set.  Returns (its launches, the mesh .lvi bytes)."""
    from longtail_tpu_torch import api
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import (
        MemStorage,
        ensure_parent_dirs,
    )

    rng = np.random.default_rng(7)
    st = MemStorage()
    st.create_dir("src")
    for path, size in [("a/big.bin", TARGET * 1024 + 333),
                       ("b/two_parts.bin", TARGET * 2048 + 11),
                       ("small.txt", 900), ("tiny", 1), ("empty", 0)]:
        ensure_parent_dirs(st, f"src/{path}")
        st.write(f"src/{path}",
                 rng.integers(0, 256, size, np.uint8).tobytes())

    def run(mesh):
        store = FSBlockStore(st, f"store_{'m' if mesh else 's'}")
        vi, vsi = api.upsync(st, "src", store, target_chunk_size=TARGET,
                             device=dev, mesh=mesh)
        store.flush()
        return vi.to_bytes(), sorted(vsi.block_hashes.tolist())

    before = _launch_counts()
    lvi_mesh, blocks_mesh = run(_devices(n, dev.type))
    after = _launch_counts()
    lvi_single, blocks_single = run(None)
    if lvi_mesh != lvi_single:
        raise AssertionError("mesh upsync .lvi differs")
    if blocks_mesh != blocks_single:
        raise AssertionError("mesh store blocks differ")
    return {k: after[k] - before[k] for k in after}, lvi_mesh


def _build_tree(root: str) -> None:
    """tests/test_multihost.py's tree."""
    rng = np.random.default_rng(77)
    for path, size in [("a/big.bin", 1024 * 1024 + 333), ("b/mid.bin", 300000),
                       ("c.bin", 150000), ("d/e/deep.bin", 70000),
                       ("small.txt", 900), ("tiny", 1), ("empty", 0)]:
        full = os.path.join(root, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(rng.integers(0, 256, size, np.uint8).tobytes())


def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _lrb_set(store_dir: str) -> set:
    return {f for _, _, fs in os.walk(store_dir) for f in fs
            if f.endswith(".lrb")}


def _two_process_leg(kind: str, tmp: str) -> dict:
    """Two processes of ``python -m longtail_tpu_torch.parallel.multihost``
    on the device: their .lvi and block set equal a single-process
    upsync's on the host path, and their sharded downsync rebuilds the
    tree.  Returns their launches, summed."""
    from longtail_tpu_torch import api
    from longtail_tpu_torch.stores.compressblockstore import (
        CompressBlockStore,
    )
    from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
    from longtail_tpu_torch.stores.storage import FSStorage

    src, out = os.path.join(tmp, "src"), os.path.join(tmp, "out_m")
    _build_tree(src)
    fs = FSStorage()
    vi, _ = api.upsync(fs, src, CompressBlockStore(FSBlockStore(
        fs, os.path.join(tmp, "store_s"))), target_chunk_size=TARGET,
        workers=4, device=None)
    env = dict(os.environ, PYTHONPATH=REPO, LT_MH_NPROC="2",
               LT_MH_COORD=f"127.0.0.1:{_free_port()}", LT_MH_SRC=src,
               LT_MH_STORE=os.path.join(tmp, "store_m"),
               LT_MH_LVI=os.path.join(tmp, "m.lvi"), LT_MH_OUT=out,
               LT_MH_TCS=str(TARGET), LT_MH_DEVICE=kind)
    outs = _run([[sys.executable, "-m",
                  "longtail_tpu_torch.parallel.multihost"]] * 2,
                [dict(env, LT_MH_PID=str(r)) for r in range(2)])
    with open(os.path.join(tmp, "m.lvi"), "rb") as f:
        if f.read() != vi.to_bytes():
            raise AssertionError("two-process .lvi differs")
    blocks = _lrb_set(os.path.join(tmp, "store_m"))
    if not blocks or blocks != _lrb_set(os.path.join(tmp, "store_s")):
        raise AssertionError("two-process store block set differs")
    if _tree(out) != _tree(src):
        raise AssertionError("sharded downsync differs from the tree")
    return _sum([json.loads(o.strip().splitlines()[-1])["launches"]
                 for o in outs])


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The distributed legs over n_devices ranks (rank r on cuda:r, or
    all on the CPU), each checked against its oracle: the sharded steps,
    the mesh upsync and the two-process upsync and downsync.  NCCL runs
    one rank per card, so on the card n_devices may not exceed the cards
    present.  Returns {"sharded", "mesh", "multihost": each leg's kernel
    launches, "lvi": the mesh upsync's .lvi bytes}."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(
            f"{n_devices} ranks need {n_devices} cards: NCCL runs one rank "
            f"per card, and {torch.cuda.device_count()} are present")
    tmp = tempfile.mkdtemp(prefix="lt_dryrun_")
    try:
        report = {"sharded": _sharded_legs(n_devices, dev.type, tmp)}
        report["mesh"], report["lvi"] = _mesh_leg(n_devices, dev)
        report["multihost"] = _two_process_leg(dev.type, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report
