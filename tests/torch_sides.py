"""The JAX package and its port side by side, for the parity tests that
hold the port to the JAX package's own host tests
(tests/test_torch_{faults,stores,host_utils,roundtrip}.py).

Each package is one namespace of the modules a scenario uses, loaded by
the same module paths, so a scenario written once against ``side`` runs
in both.  ``upsync`` and ``downsync`` run the JAX package's host path
(``xp=np``, its default) and the port's ``device="cpu"`` (the kernels'
plain versions); the JAX downsync gets ``min_block_usage_percent=0``,
the port's default (the JAX default of 80 crashes an incremental
downsync).  ``same`` runs a scenario in both and asserts one result.
"""

from __future__ import annotations

import importlib
import types

import numpy as np

_MODULES = {
    "api": "api",
    "cli": "cli",
    "C": "formats.constants",
    "version_index": "formats.version_index",
    "store_index": "formats.store_index",
    "storage": "stores.storage",
    "blockstore": "stores.blockstore",
    "fsblockstore": "stores.fsblockstore",
    "compressblockstore": "stores.compressblockstore",
    "cacheblockstore": "stores.cacheblockstore",
    "prefetchblockstore": "stores.prefetchblockstore",
    "shareblockstore": "stores.shareblockstore",
    "lrublockstore": "stores.lrublockstore",
    "blockstorestorage": "stores.blockstorestorage",
    "archiveblockstore": "stores.archiveblockstore",
    "store_algebra": "core.store_algebra",
    "change": "core.change",
    "dedup": "core.dedup",
    "diff": "core.diff",
    "write": "core.write",
    "indexing": "core.indexing",
    "brotli": "ops.brotli",
    "jobgraph": "parallel.jobgraph",
    "cancel": "utils.cancel",
    "progress": "utils.progress",
    "memtracer": "utils.memtracer",
    "monitor": "utils.monitor",
    "detailed_progress": "utils.detailed_progress",
}


def _load(package: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(name=package, **{
        key: importlib.import_module(f"{package}.{path}")
        for key, path in _MODULES.items()})


JAX = _load("longtail_tpu")
PORT = _load("longtail_tpu_torch")
SIDES = (JAX, PORT)


def upsync(side, *args, **kwargs):
    if side is PORT:
        kwargs.setdefault("device", "cpu")
    return side.api.upsync(*args, **kwargs)


def downsync(side, *args, **kwargs):
    if side is PORT:
        kwargs.setdefault("device", "cpu")
    else:
        kwargs.setdefault("min_block_usage_percent", 0)
    return side.api.downsync(*args, **kwargs)


def same(scenario, *args, **kwargs):
    """Run ``scenario(side, ...)`` in the JAX package, then in the port;
    assert the two results are equal and return the port's."""
    want, got = (scenario(side, *args, **kwargs) for side in SIDES)
    assert got == want, f"port {got!r} != JAX package {want!r}"
    return got


def make_source(storage, root: str, rng) -> dict[str, bytes]:
    """tests/test_roundtrip.py's tree: text, random and low-entropy
    binaries, a nested file, an empty file and a non-ASCII path."""
    files = {
        "readme.txt": b"hello longtail tpu\n" * 10,
        "bin/a.dat": rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
        "bin/b.dat": rng.integers(0, 4, 150_000, dtype=np.uint8).tobytes(),
        "bin/sub/c.bin": rng.integers(0, 256, 1_000, dtype=np.uint8).tobytes(),
        "empty.txt": b"",
        "strange/€.txt": "euro € file".encode("utf-8"),
    }
    for path, data in files.items():
        parts = path.split("/")
        for d in range(1, len(parts)):
            p = f"{root}/" + "/".join(parts[:d])
            if not storage.is_dir(p):
                storage.create_dir(p)
        storage.write(f"{root}/{path}", data)
    return files


def read_tree(side, storage, root: str) -> dict[str, bytes]:
    return {path: storage.read(f"{root}/{path}")
            for path, _size, _perm in side.storage.walk_files(storage, root)
            if not path.endswith("/")}


def block_hashes(index) -> list[int]:
    return sorted(int(h) for h in index.block_hashes)
