"""Each asset's path and content hash (``core/indexing.hash_assets``):
the native batch route and the per-asset route give the JAX package's
``assemble_chunked_assets`` hashes, bit for bit, and only the batch
records ``index.asset_hash.batch``."""

import importlib

import numpy as np
import pytest

from longtail_tpu_torch.ops import blake3
from longtail_tpu_torch.utils import monitor
from tests.torch_sides import JAX, PORT

# (path, chunk count) of each asset
CASES = {
    "no_assets": [],
    "empty_asset": [("empty.bin", 0)],
    "one_chunk": [("one.bin", 1)],
    "one_leaf": [("leaf.bin", 128)],           # 1,024 bytes of chunk hashes
    "two_leaves": [("two.bin", 129)],
    "three_levels": [("deep.bin", 4097)],
    "non_ascii_path": [("strange/€ñ漢字.txt", 3), ("a/ß", 0)],
    "long_path": [("d/" + "long_name-" * 110 + ".bin", 5)],
    "mixed": [("dir/", 0), ("dir/a", 7), ("dir/empty", 0), ("€/b", 129),
              ("c", 1)],
}


def _run(side, kind: int, case: str, hasher=None):
    rng = np.random.default_rng(sum(map(ord, case)))
    assets = CASES[case]
    results = [(rng.integers(0, 1 << 63, n, dtype=np.uint64),
                rng.integers(1, 1 << 16, n, dtype=np.uint32))
               for _, n in assets]
    infos = side.indexing.FileInfos.from_entries(
        [(p, int(r[1].sum()), 0o644) for (p, _), r in zip(assets, results)])
    if hasher is None:
        hasher = _hasher(side, kind)
    ca = side.indexing.assemble_chunked_assets(results, infos, hasher)
    return ca.path_hashes, ca.content_hashes


def _hasher(side, kind: int):
    registry = importlib.import_module(f"{side.name}.ops.hash_registry")
    return registry.get_hasher(kind)


def _batches():
    return [s for s in monitor.spans() if s.name == "index.asset_hash.batch"]


@pytest.fixture
def recording():
    monitor.set_monitor(monitor.Monitor())
    try:
        yield
    finally:
        monitor.set_monitor(None)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route", ["batch", "per_asset"])
def test_blake3_route_equals_the_jax_package(recording, monkeypatch, route,
                                             case):
    kind = PORT.C.HASH_TYPE_BLAKE3
    hasher = _hasher(PORT, kind)
    if route == "batch":
        if blake3._native() is None:
            pytest.skip("no C compiler")
    else:
        monkeypatch.setattr(hasher, "hash_ranges", lambda *a: None)
    paths, contents = _run(PORT, kind, case, hasher)
    want_paths, want_contents = _run(JAX, kind, case)
    assert paths.dtype == contents.dtype == np.uint64
    assert paths.tolist() == want_paths.tolist()
    assert contents.tolist() == want_contents.tolist()
    count = len(CASES[case])
    assert [s.n for s in _batches()] == \
        ([count] if route == "batch" and count else [])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["blake2", "meow"])
def test_other_hashers_keep_the_loop(recording, name, case):
    kind = getattr(PORT.C, f"HASH_TYPE_{name.upper()}")
    paths, contents = _run(PORT, kind, case)
    want_paths, want_contents = _run(JAX, kind, case)
    assert paths.tolist() == want_paths.tolist()
    assert contents.tolist() == want_contents.tolist()
    assert _batches() == []
