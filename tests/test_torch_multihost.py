"""The port's multi-process paths on the CPU over gloo, loopback only:
the all-gather dedup steps of ``parallel/distributed.py`` in two spawned
ranks against the JAX package's shard_map steps over two virtual CPU
devices, and the two-process dry run of ``parallel/multihost.py``
against the JAX package's single-process upsync.  Every comparison is
exact."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from longtail_tpu import api as japi  # noqa: E402
from longtail_tpu.core.indexing import (  # noqa: E402
    get_files_recursively as j_get_files_recursively,
)
from longtail_tpu.parallel import distributed as jdist  # noqa: E402
from longtail_tpu.parallel import multihost as jmultihost  # noqa: E402
from longtail_tpu.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig as JChunkerConfig,
)
from longtail_tpu.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore as JCompressBlockStore,
)
from longtail_tpu.stores.fsblockstore import (  # noqa: E402
    FSBlockStore as JFSBlockStore,
)
from longtail_tpu.stores.storage import FSStorage as JFSStorage  # noqa: E402
from longtail_tpu_torch.core.indexing import (  # noqa: E402
    get_files_recursively,
)
from longtail_tpu_torch.parallel import distributed, multihost  # noqa: E402
from longtail_tpu_torch.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig,
)
from longtail_tpu_torch.stores.storage import FSStorage  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = 1024
TIMEOUT = 300


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(argvs, envs) -> None:
    """Run one process per (argv, env) from the repository root, wait for
    all (killing all on a timeout), and raise with the output of any
    that failed."""
    procs = [subprocess.Popen(argv, env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"


# ---------------------------------------------------------------------------
# parallel/distributed.py: two gloo ranks against a 2-device CPU mesh
# ---------------------------------------------------------------------------

# one rank: its half of the batch through both steps, outputs to an .npz
_RANK = """
import sys
import numpy as np
import torch
from longtail_tpu_torch.parallel import distributed, multihost
from longtail_tpu_torch.parallel.device_chunker import ChunkerConfig
addr, rank, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
multihost.initialize(addr, 2, rank)
d = np.load(inp)
half = len(d["parts"]) // 2
mine = slice(rank * half, (rank + 1) * half)
parts, lengths = torch.from_numpy(d["parts"][mine]), d["lengths"][mine]
cfg = ChunkerConfig.from_target(int(d["target"]))
res = {}
for k, x in zip(("ends", "sizes", "ulo", "uhi", "n"),
                distributed.sharded_index_step(parts, lengths, cfg)):
    res["index_" + k] = x.numpy()
for slots in d["slots"]:
    for k, x in zip(("sizes", "lo", "hi", "ulo", "uhi", "n", "ov"),
                    distributed.sharded_chunk_step(parts, lengths, cfg,
                                                   int(slots))):
        res[f"chunk{int(slots)}_" + k] = x.numpy()
np.savez(out, **res)
torch.distributed.destroy_process_group()
"""


def test_sharded_steps_over_two_gloo_ranks_match_jax(tmp_path):
    """Two spawned gloo ranks each take half of a batch: their
    sharded_index_step and sharded_chunk_step outputs (ends, sizes,
    uniq_lo/uniq_hi, n_uniq, overflow; lo/hi where sizes > 0) equal the
    JAX package's steps over a 2-device CPU mesh, the unique set is the
    same on both ranks, and a dedup_slots below a rank's chunk count
    raises the overflow count."""
    cfg, jcfg = ChunkerConfig.from_target(TARGET), \
        JChunkerConfig.from_target(TARGET)
    rng = np.random.default_rng(5)
    B, P = 4, 4096
    parts = rng.integers(0, 256, size=(B, P), dtype=np.uint8)
    parts[2, 2048:] = parts[2, :2048]       # a chunk repeated: dedup work
    lengths = np.array([P, 57, P, 0], np.int32)
    default = distributed.default_dedup_slots(cfg, B // 2, P)
    assert default == jdist.default_dedup_slots(jcfg, B // 2, P)
    small = 3
    inp = str(tmp_path / "in.npz")
    np.savez(inp, parts=parts, lengths=lengths, target=TARGET,
             slots=np.array([default, small]))
    addr = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    _run_ranks([[sys.executable, "-c", _RANK, addr, str(r), inp, outs[r]]
                for r in range(2)], [env, env])
    ranks = [dict(np.load(o)) for o in outs]

    mesh = Mesh(np.asarray(jax.devices("cpu")[:2]), ("d",))
    want = [np.asarray(x) for x in
            jdist.make_sharded_index_fn(jcfg, mesh)(parts, lengths)]
    for k, w in zip(("ends", "sizes"), want[:2]):
        np.testing.assert_array_equal(
            np.concatenate([r["index_" + k] for r in ranks]), w)
    for r in ranks:
        for k, w in zip(("ulo", "uhi", "n"), want[2:]):
            np.testing.assert_array_equal(r["index_" + k],
                                          w.astype(r["index_" + k].dtype))
    n_uniq = int(want[4])
    assert 0 < n_uniq < int((want[1] > 0).sum())     # something deduped

    for slots in (default, small):
        step = jax.jit(lambda p, l, s=slots: jdist.sharded_chunk_step(
            p, l, jcfg, mesh, s))
        jsizes, jlo, jhi, julo, juhi, jn, jov = (np.asarray(x) for x in
                                                 step(parts, lengths))
        sizes = np.concatenate([r[f"chunk{slots}_sizes"] for r in ranks])
        np.testing.assert_array_equal(sizes, jsizes)
        valid = sizes > 0
        for k, w in (("lo", jlo), ("hi", jhi)):
            got = np.concatenate([r[f"chunk{slots}_{k}"] for r in ranks])
            np.testing.assert_array_equal(got[valid],
                                          w[valid].astype(np.int64))
            assert not got[~valid].any()
        for r in ranks:
            for k, w in (("ulo", julo), ("uhi", juhi), ("n", jn),
                         ("ov", jov)):
                np.testing.assert_array_equal(
                    r[f"chunk{slots}_{k}"], w.astype(r[f"chunk{slots}_{k}"]
                                                     .dtype))
        assert int(jov) == (2 if slots == small else 0)
    got = distributed.host_unique_hashes(
        ranks[0]["index_ulo"], ranks[0]["index_uhi"], ranks[0]["index_n"])
    np.testing.assert_array_equal(
        got, jdist.host_unique_hashes(want[2], want[3], want[4]))


# ---------------------------------------------------------------------------
# parallel/multihost.py
# ---------------------------------------------------------------------------

def _build_tree(root):
    """tests/test_multihost.py's tree."""
    rng = np.random.default_rng(77)
    spec = [("a/big.bin", 1024 * 1024 + 333), ("b/mid.bin", 300000),
            ("c.bin", 150000), ("d/e/deep.bin", 70000),
            ("small.txt", 900), ("tiny", 1), ("empty", 0)]
    for path, size in spec:
        full = os.path.join(root, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(rng.integers(0, 256, size, np.uint8).tobytes())


def _files(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _blocks(d) -> set:
    return {f for _, _, fs in os.walk(d) for f in fs if f.endswith(".lrb")}


def test_two_process_dry_run_matches_the_jax_single_process_upsync(
        tmp_path):
    """Two processes of ``python -m longtail_tpu_torch.parallel.multihost``
    with LT_MH_DEVICE=cpu over tests/test_multihost.py's tree: the .lvi
    process 0 writes equals the JAX package's single-process api.upsync
    byte for byte, the shared store holds the same .lrb block set, and
    the sharded downsync rebuilds the tree."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    _build_tree(src)
    jst = JFSStorage()
    vi_s, _ = japi.upsync(jst, src, JCompressBlockStore(
        JFSBlockStore(jst, str(tmp_path / "store_s"))),
        target_chunk_size=TARGET, workers=4)

    env = dict(os.environ, PYTHONPATH=REPO, LT_MH_NPROC="2",
               LT_MH_COORD=f"127.0.0.1:{_free_port()}", LT_MH_SRC=src,
               LT_MH_STORE=str(tmp_path / "store_m"),
               LT_MH_LVI=str(tmp_path / "vm.lvi"),
               LT_MH_OUT=str(tmp_path / "out_m"), LT_MH_TCS=str(TARGET),
               LT_MH_DEVICE="cpu")
    _run_ranks([[sys.executable, "-m", "longtail_tpu_torch.parallel."
                 "multihost"]] * 2,
               [dict(env, LT_MH_PID=str(r)) for r in range(2)])
    assert open(tmp_path / "vm.lvi", "rb").read() == vi_s.to_bytes()
    blocks = _blocks(tmp_path / "store_m")
    assert blocks and blocks == _blocks(tmp_path / "store_s")
    assert _files(tmp_path / "out_m") == _files(src)


def test_shard_and_one_process_exchange_equal_the_jax_packages(tmp_path):
    """shard_assets deals the same assets as the JAX package's for every
    process of 1 to 3; with one process (no process group)
    exchange_chunk_results returns the results as they are, and
    process_info is (0, 1)."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    _build_tree(src)
    os.makedirs(os.path.join(src, "emptydir"))
    fi = get_files_recursively(FSStorage(), src)
    jfi = j_get_files_recursively(JFSStorage(), src)
    for n in (1, 2, 3):
        for pid in range(n):
            np.testing.assert_array_equal(
                multihost.shard_assets(fi, pid, n),
                jmultihost.shard_assets(jfi, pid, n))
    assert multihost.process_info() == (0, 1)
    rng = np.random.default_rng(1)
    results = [(rng.integers(0, 2**63, k, dtype=np.uint64),
                rng.integers(1, 9999, k).astype(np.uint32)) for k in (3, 0, 5)]
    for fn in (multihost.exchange_chunk_results,
               jmultihost.exchange_chunk_results):
        got = fn([0, 2], results, 3)
        for (h, s), (wh, ws) in zip(got, results, strict=True):
            np.testing.assert_array_equal(h, wh)
            np.testing.assert_array_equal(s, ws)
