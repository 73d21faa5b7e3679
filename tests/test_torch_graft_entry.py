"""``__graft_entry_torch__.py`` held against ``__graft_entry__.py`` on the
CPU: the port's step (the plain versions of the scan, walk, pack and
BLAKE3 kernels) against the JAX step under ``jax.jit`` (its Pallas
kernels in interpret mode) and the host oracles, and the port's
distributed dry run over gloo ranks, two "cpu" indexers and two
processes against the JAX package's upsync.  Every comparison is
exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import __graft_entry__ as jentry  # noqa: E402
import __graft_entry_torch__ as entry  # noqa: E402
from longtail_tpu import api as japi  # noqa: E402
from longtail_tpu.ops import blake3 as jblake3  # noqa: E402
from longtail_tpu.ops import cdc as jcdc  # noqa: E402
from longtail_tpu.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig as JChunkerConfig,
)
from longtail_tpu.stores.fsblockstore import (  # noqa: E402
    FSBlockStore as JFSBlockStore,
)
from longtail_tpu.stores.storage import MemStorage as JMemStorage  # noqa: E402
from longtail_tpu.stores.storage import (  # noqa: E402
    ensure_parent_dirs as j_ensure_parent_dirs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def steps():
    """(the port's outputs on the CPU, the JAX step's, its args) as
    numpy."""
    fn, args = entry.entry(device="cpu")
    got = [x.numpy() for x in fn(*args)]
    jfn, jargs = jentry.entry()
    want = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    return got, want, jargs


def test_entry_equals_the_jax_step(steps):
    """sizes, n and every one of the rows slots of lo/hi, the size-0 slots
    past lane 0's count included, equal the JAX step's; lo/hi carry the
    u32 words as int32."""
    got, want, (rows_u8, lengths) = steps
    batch, lens = entry.entry(device="cpu")[1]
    np.testing.assert_array_equal(batch.numpy(), rows_u8.reshape(-1))
    np.testing.assert_array_equal(lens.numpy(), lengths)
    for name, g, w in zip(("sizes", "n", "lo", "hi"), got, want,
                          strict=True):
        assert g.dtype == np.int32, name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
    n0 = int(got[1][0])
    assert 0 < n0 < got[2].shape[0]         # empty slots are compared too


def test_entry_lane0_equals_the_host_oracles(steps):
    """Lane 0's sizes and digests against the JAX package's chunk_part and
    hash64_ranges (as tests/test_distributed.py checks the JAX step), and
    the slots past its count hold BLAKE3-64 of the empty input."""
    (sizes, n, lo, hi), _, (rows_u8, lengths) = steps
    cfg = JChunkerConfig.from_target(1024)
    data0 = rows_u8.reshape(-1)[: int(lengths[0])]
    ends0 = jcdc.chunk_part(data0, cfg.min_size, cfg.avg_size, cfg.max_size)
    ref_sizes = np.diff(np.concatenate([[0], ends0]))
    k = len(ref_sizes)
    assert int(n[0]) == k
    np.testing.assert_array_equal(sizes[0, :k], ref_sizes)
    assert not sizes[0, k:].any()
    st0 = np.concatenate([[0], ends0[:-1]]).astype(np.int64)
    want = jblake3.hash64_ranges(data0, st0, ref_sizes.astype(np.int64))
    words = lo.astype(np.uint32).astype(np.uint64) | (
        hi.astype(np.uint32).astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(words[:k], want)
    assert (words[k:] == np.uint64(jblake3.hash64(b""))).all()


# the dry run in a fresh interpreter (tests/conftest.py imports jax in
# this one): entry() and dryrun_multichip(2) on the CPU, then the mesh
# leg's .lvi and the foreign modules loaded
_DRYRUN = """
import json, sys
import __graft_entry_torch__ as g
fn, args = g.entry(device="cpu")
fn(*args)
report = g.dryrun_multichip(2, device="cpu")
open(sys.argv[1], "wb").write(report.pop("lvi"))
report["foreign"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "longtail_tpu"))
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    lvi = str(tmp_path_factory.mktemp("dryrun") / "mesh.lvi")
    out = subprocess.run([sys.executable, "-c", _DRYRUN, lvi], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), check=True,
                         capture_output=True, text=True, timeout=600).stdout
    with open(lvi, "rb") as f:
        return json.loads(out.strip().splitlines()[-1]), f.read()


def test_dryrun_multichip_mesh_lvi_equals_the_jax_packages(dryrun):
    """dryrun_multichip(2, device="cpu") passes every leg (gloo ranks, two
    "cpu" indexers, two processes), launches no kernel on the CPU, and
    its mesh upsync's .lvi equals the JAX package's host-path upsync of
    the same seed-7 tree byte for byte."""
    report, lvi = dryrun
    for leg in ("sharded", "mesh", "multihost"):
        assert not any(report[leg].values()), (leg, report[leg])
    rng = np.random.default_rng(7)
    st = JMemStorage()
    st.create_dir("src")
    for path, size in [("a/big.bin", 1024 * 1024 + 333),
                       ("b/two_parts.bin", 1024 * 2048 + 11),
                       ("small.txt", 900), ("tiny", 1), ("empty", 0)]:
        j_ensure_parent_dirs(st, f"src/{path}")
        st.write(f"src/{path}",
                 rng.integers(0, 256, size, np.uint8).tobytes())
    vi, _ = japi.upsync(st, "src", JFSBlockStore(st, "store"),
                        target_chunk_size=1024, min_block_usage_percent=0)
    assert lvi == vi.to_bytes()


def test_entry_and_dryrun_load_no_jax(dryrun):
    """After entry(device="cpu") and dryrun_multichip(2, device="cpu") a
    fresh interpreter holds no module of jax or of the JAX package."""
    assert dryrun[0]["foreign"] == []


@pytest.mark.parametrize("call", [
    lambda: entry.entry(),
    lambda: entry.dryrun_multichip(2, device="cuda"),
], ids=["entry", "dryrun_multichip"])
def test_the_card_without_a_card_raises(call):
    """The card is the default and nothing falls back to the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_more_ranks_than_cards_raises(monkeypatch):
    """NCCL runs one rank per card: on the card, more ranks than cards
    raise before any leg starts, naming the limit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        entry.dryrun_multichip(2, device="cuda")
