"""The port's own ``api`` and CLI held against the JAX package's on the
host path: a two-version upsync writes the same ``.lvi``, ``.lsi`` and
block files, an incremental downsync reproduces each version, ``validate``
agrees, and all seven CLI commands on ``tests/testdata/sample_folder``
write the same files and print the same lines."""

import os
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

from longtail_tpu import api as japi  # noqa: E402
from longtail_tpu import cli as jcli  # noqa: E402
from longtail_tpu.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore as JCompressBlockStore,
)
from longtail_tpu.stores.fsblockstore import (  # noqa: E402
    FSBlockStore as JFSBlockStore,
)
from longtail_tpu.stores.storage import FSStorage as JFSStorage  # noqa: E402
from longtail_tpu_torch import api, cli  # noqa: E402
from longtail_tpu_torch.formats import constants as C  # noqa: E402
from longtail_tpu_torch.formats.version_index import (  # noqa: E402
    VersionIndex,
)
from longtail_tpu_torch.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore,
)
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore  # noqa: E402
from longtail_tpu_torch.stores.storage import (  # noqa: E402
    FSStorage,
    ensure_parent_dirs,
)

SAMPLE = str(pathlib.Path(__file__).parent / "testdata" / "sample_folder")
TARGET = 1024
V1 = [("big.bin", TARGET * 1024 + 4321), ("a/small.txt", 300),
      ("a/b/mid.dat", 9000), ("empty", 0), ("gone.bin", 5000)]


def _files(root) -> dict:
    """Every file under root by relative path, and every directory."""
    out = {}
    for d, dirs, files in os.walk(root):
        for n in dirs:
            out[os.path.relpath(os.path.join(d, n), root) + "/"] = None
        for n in files:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _write_versions(fs, root):
    """v1 from seeded bytes, then v2: one file edited in the middle, one
    removed, one added; returns the two trees' roots."""
    rng = np.random.default_rng(17)
    v1, v2 = f"{root}/v1", f"{root}/v2"
    for base in (v1, v2):
        fs.create_dir(base)
    for path, size in V1:
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for base in (v1, v2):
            if base == v2 and path == "gone.bin":
                continue
            if base == v2 and path == "big.bin":
                data = data[:5000] + b"edited" + data[5006:]
            ensure_parent_dirs(fs, f"{base}/{path}")
            fs.write(f"{base}/{path}", data)
    fs.write(f"{v2}/a/new.txt", b"new in v2\n" * 50)
    return v1, v2


@pytest.mark.parametrize("device", [None, "cpu"])
def test_two_version_upsync_downsync_validate_equal_the_jax_packages(
        tmp_path, device):
    """The port's api (data plane on the host path, or the plain versions
    on the CPU) against the JAX package's host path, store by store."""
    fs, jfs = FSStorage(), JFSStorage()
    v1, v2 = _write_versions(fs, str(tmp_path))
    mine, theirs = str(tmp_path / "s_port"), str(tmp_path / "s_jax")
    kw = dict(target_chunk_size=TARGET, workers=1,
              compression_tag=C.COMPRESSION_TYPE_ZSTD_DEFAULT)
    for src in (v1, v2):
        vi, vsi = api.upsync(fs, src, CompressBlockStore(
            FSBlockStore(fs, mine)), device=device, **kw)
        jvi, jvsi = japi.upsync(jfs, src, JCompressBlockStore(
            JFSBlockStore(jfs, theirs)), **kw)
        assert vi.to_bytes() == jvi.to_bytes()
        assert vsi.to_bytes() == jvsi.to_bytes()
        assert _files(mine) == _files(theirs)
        fs.write(f"{src}.lvi", vi.to_bytes())

    store = CompressBlockStore(FSBlockStore(fs, mine))
    out = str(tmp_path / "out")
    for src in (v1, v2):                    # v2 lands over v1: incremental
        vi = VersionIndex.from_bytes(fs.read(f"{src}.lvi"))
        api.downsync(store, fs, out, vi, workers=2, device=None)
        assert _files(out) == _files(src)
        jout = str(tmp_path / f"jout_{os.path.basename(src)}")
        japi.downsync(JCompressBlockStore(JFSBlockStore(jfs, theirs)), jfs,
                      jout, vi, min_block_usage_percent=0, workers=2)
        assert _files(jout) == _files(out)
        assert api.validate_version(store, vi).ok

    # a store that holds v1 alone: both packages miss the same v2 chunks
    only1, jonly1 = str(tmp_path / "v1_port"), str(tmp_path / "v1_jax")
    api.upsync(fs, v1, FSBlockStore(fs, only1), device=None, **kw)
    japi.upsync(jfs, v1, JFSBlockStore(jfs, jonly1), **kw)
    got = api.validate_version(FSBlockStore(fs, only1), vi)
    want = japi.validate_version(JFSBlockStore(jfs, jonly1), vi)
    assert not got.ok and not want.ok
    for k in ("missing_chunk_hashes", "size_mismatch_chunk_hashes"):
        np.testing.assert_array_equal(np.sort(getattr(got, k)),
                                      np.sort(getattr(want, k)))
    assert len(got.missing_chunk_hashes)


def _commands(base):
    """The seven CLI commands in order (command name, argv)."""
    store, lvi = f"{base}/store", f"{base}/v.lvi"
    return [
        ("upsync", ["upsync", "--storage-uri", store, "--source-path",
                    SAMPLE, "--target-path", lvi, "--target-chunk-size",
                    "512", "--version-local-store-index-path",
                    f"{base}/v.lsi"]),
        ("validate", ["validate", "--storage-uri", store,
                      "--version-index-path", lvi]),
        ("ls", ["ls", "--version-index-path", lvi]),
        ("cp", ["cp", "--storage-uri", store, "--version-index-path", lvi,
                "JustDifferent.txt", f"{base}/copied.txt"]),
        ("downsync", ["downsync", "--storage-uri", store, "--source-path",
                      lvi, "--target-path", f"{base}/down"]),
        ("pack", ["pack", "--source-path", SAMPLE, "--target-path",
                  f"{base}/a.la", "--target-chunk-size", "512",
                  "--compression-algorithm", "lz4"]),
        ("unpack", ["unpack", "--source-path", f"{base}/a.la",
                    "--target-path", f"{base}/unpacked"]),
    ]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs through all seven commands, each in its own directory:
    {name: (port (rc, stdout, files), JAX package's)} per command."""
    import contextlib
    import io

    runs = {}
    for who, main, extra in (("port", cli.main, ["--device", "host"]),
                             ("jax", jcli.main, [])):
        base = str(tmp_path_factory.mktemp(f"cli_{who}"))
        for name, argv in _commands(base):
            # one worker: blocks reach the store (and its index) in order
            argv = ["--workers", "1"] + argv + \
                (extra if name in ("upsync", "pack") else [])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
            out = buf.getvalue().replace(base, "<base>")
            runs.setdefault(name, {})[who] = (rc, out, _files(base))
    return runs


@pytest.mark.parametrize("name", [n for n, _ in _commands("")])
def test_cli_command_equals_the_jax_packages(cli_runs, name):
    """After each command, the same return code, the same lines printed
    and the same files (every byte of the store, the .lvi, .lsi and .la,
    the copied, downsynced and unpacked trees)."""
    got, want = cli_runs[name]["port"], cli_runs[name]["jax"]
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[2] == want[2]
    if name in ("downsync", "unpack"):
        sub = "down" if name == "downsync" else "unpacked"
        tree = {k[len(sub) + 1:]: v for k, v in got[2].items()
                if k.startswith(sub + "/") and k != sub + "/"}
        assert tree == _files(SAMPLE)
