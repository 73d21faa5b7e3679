"""The port's several-device data plane on the CPU, held against the JAX
package over virtual CPU devices: ``MeshPartIndexer`` (two indexers on
"cpu"), the mesh route of ``api.upsync``, and the single-step
``index_parts``.  Every comparison is exact (sizes, ends, 64-bit hashes,
``.lvi`` bytes)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from longtail_tpu import api as japi  # noqa: E402
from longtail_tpu.parallel import pipeline as jpipeline  # noqa: E402
from longtail_tpu.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig as JChunkerConfig,
    make_index_parts_fn,
)
from longtail_tpu.stores.fsblockstore import (  # noqa: E402
    FSBlockStore as JFSBlockStore,
)
from longtail_tpu.stores.storage import MemStorage as JMemStorage  # noqa: E402
from longtail_tpu_torch import api  # noqa: E402
from longtail_tpu_torch.parallel import pipeline  # noqa: E402
from longtail_tpu_torch.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig,
    index_parts,
)
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore  # noqa: E402
from longtail_tpu_torch.stores.storage import (  # noqa: E402
    MemStorage,
    ensure_parent_dirs,
)

torch.set_num_threads(1)

TARGET = 1024


def _two_cpu_devices():
    """Two of the virtual CPU devices that tests/conftest.py asks for."""
    devices = jax.devices("cpu")
    assert len(devices) >= 2, devices
    return devices[:2]


def test_mesh_part_indexer_matches_single_and_jax():
    """MeshPartIndexer over two indexers on "cpu": the parts of
    tests/test_distributed.py's mesh test come back in submission order
    with the sizes and hashes of one DevicePartIndexer and of the JAX
    package's MeshPartIndexer over two CPU devices."""
    mesh_ix = pipeline.MeshPartIndexer(TARGET, ["cpu", "cpu"], lanes=2)
    assert [ix.device.type for ix in mesh_ix.indexers] == ["cpu", "cpu"]
    single = pipeline.DevicePartIndexer(TARGET, "cpu", lanes=2)
    jmesh = jpipeline.MeshPartIndexer(TARGET, _two_cpu_devices(), lanes=2)

    rng = np.random.default_rng(13)
    P = mesh_ix.part_bytes
    parts = [(i, rng.integers(0, 256, size=n, dtype=np.uint8))
             for i, n in enumerate(
                 [P, P // 2 + 13, 1, 700, P - 1, P // 3, 4096, P])]

    got = list(mesh_ix.index_stream(iter(parts), prefetch_depth=0))
    one = list(single.index_stream(iter(parts), prefetch_depth=0))
    want = list(jmesh.index_stream(iter(parts), prefetch_depth=0))
    assert [t for t, _, _ in got] == [t for t, _ in parts]
    for (tg, sg, hg), (to, so, ho), (tw, sw, hw) in zip(got, one, want,
                                                        strict=True):
        assert tg == to == tw
        np.testing.assert_array_equal(sg, so)
        np.testing.assert_array_equal(sg, np.asarray(sw))
        np.testing.assert_array_equal(hg, ho)
        np.testing.assert_array_equal(hg, np.asarray(hw))


def test_mesh_part_indexer_deals_batches_round_robin(monkeypatch):
    """Five batches over two indexers: indexer 0 takes batches 0, 2, 4
    and indexer 1 batches 1, 3, each retiring its own entries."""
    mesh_ix = pipeline.MeshPartIndexer(TARGET, ["cpu", "cpu"], lanes=1)
    seen = []
    for k, ix in enumerate(mesh_ix.indexers):
        submit = ix.submit_host

        def counted(batch, k=k, submit=submit):
            seen.append((k, batch[0][0]))
            return submit(batch)

        monkeypatch.setattr(ix, "submit_host", counted)
    rng = np.random.default_rng(2)
    parts = [(i, rng.integers(0, 256, 3000 + i, np.uint8)) for i in range(5)]
    got = list(mesh_ix.index_stream(iter(parts), prefetch_depth=0))
    assert [t for t, _, _ in got] == list(range(5))
    assert seen == [(0, 0), (1, 1), (0, 2), (1, 3), (0, 4)]


def test_mesh_upsync_writes_the_jax_and_host_lvi():
    """api.upsync(mesh=["cpu", "cpu"]) writes the .lvi of the JAX
    package's api.upsync over a 2-device CPU mesh and of the port's host
    path, on tests/test_distributed.py's tree (a multi-part file, a small
    file through the mesh too, an empty file)."""
    rng = np.random.default_rng(23)
    spec = [("a.bin", 1024 * 1024 + 17), ("b/c.bin", 2048), ("empty", 0)]
    data = {p: rng.integers(0, 256, n, np.uint8).tobytes() for p, n in spec}
    st, jst = MemStorage(), JMemStorage()
    for s in (st, jst):
        s.create_dir("src")
        for path, blob in data.items():
            ensure_parent_dirs(s, f"src/{path}")
            s.write(f"src/{path}", blob)

    def port(tag, **kw):
        vi, _ = api.upsync(st, "src", FSBlockStore(st, f"st_{tag}"),
                           target_chunk_size=TARGET, **kw)
        return vi.to_bytes()

    mesh = Mesh(np.asarray(_two_cpu_devices()), ("d",))
    jvi, _ = japi.upsync(jst, "src", JFSBlockStore(jst, "st_j"),
                         target_chunk_size=TARGET, mesh=mesh)
    got = port("m", mesh=["cpu", "cpu"], device="cpu")
    assert got == jvi.to_bytes()
    assert got == port("h", device=None)


@pytest.mark.parametrize("P", [4096, 6000])
def test_index_parts_matches_jax(P):
    """index_parts on the CPU equals the JAX make_index_parts_fn: random
    parts with a length-1 lane, a ragged lane, a lane of min_size bytes
    and a zero lane (P = 6000 is no multiple of the kernels' 4 KiB tile);
    padding slots have size 0, the lane's length as end and zero hash
    words."""
    cfg = ChunkerConfig.from_target(TARGET)
    rng = np.random.default_rng(5)
    B = 6
    parts = rng.integers(0, 256, size=(B, P), dtype=np.uint8)
    lengths = np.array([P, 1, P - 777, 0, cfg.min_size, P], np.int32)
    ends, sizes, lo, hi = (x.numpy() for x in index_parts(
        torch.from_numpy(parts), torch.from_numpy(lengths), cfg))
    jends, jsizes, jlo, jhi = (np.asarray(x) for x in make_index_parts_fn(
        JChunkerConfig.from_target(TARGET))(parts, lengths))
    assert ends.dtype == sizes.dtype == np.int32
    assert sizes.shape == (B, cfg.max_chunks(P))
    np.testing.assert_array_equal(ends, jends)
    np.testing.assert_array_equal(sizes, jsizes)
    valid = sizes.reshape(-1) > 0
    assert valid.sum() > B and (sizes[3] == 0).all() and sizes[1, 0] == 1
    np.testing.assert_array_equal(lo[valid], jlo[valid].astype(np.int64))
    np.testing.assert_array_equal(hi[valid], jhi[valid].astype(np.int64))
    assert not lo[~valid].any() and not hi[~valid].any()
