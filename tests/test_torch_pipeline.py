"""The port's pipeline and slice (pack, size classes, DevicePartIndexer,
create_version_index, upsync, CLI) on the CPU path, held against the
JAX package; plus the port's import and device rules."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from longtail_tpu import api as japi  # noqa: E402
from longtail_tpu.core.indexing import (  # noqa: E402
    create_version_index as j_create_version_index,
)
from longtail_tpu.formats.version_index import VersionIndex  # noqa: E402
from longtail_tpu.ops import blake3 as jblake3, cdc, lz4  # noqa: E402
from longtail_tpu.parallel import device_match as jdm  # noqa: E402
from longtail_tpu.parallel import pipeline as jpipeline  # noqa: E402
from longtail_tpu.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig as JChunkerConfig,
)
from longtail_tpu.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore,
)
from longtail_tpu.stores.fsblockstore import FSBlockStore  # noqa: E402
from longtail_tpu.stores.storage import (  # noqa: E402
    FSStorage,
    MemStorage,
    ensure_parent_dirs,
)
from longtail_tpu_torch import _kernels, api, cli  # noqa: E402
from longtail_tpu_torch.core.indexing import (  # noqa: E402
    create_version_index,
)
from longtail_tpu_torch.ops import pack as tpack  # noqa: E402
from longtail_tpu_torch.parallel import pipeline  # noqa: E402
from longtail_tpu_torch.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig,
)
from longtail_tpu_torch.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore as TCompressBlockStore,
)
from longtail_tpu_torch.stores.fsblockstore import (  # noqa: E402
    FSBlockStore as TFSBlockStore,
)
from longtail_tpu_torch.stores.storage import (  # noqa: E402
    FSStorage as TFSStorage,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = 1024
# tests/test_pipeline.py's mixed tree: multi-part, exact part, tiny, empty
SPEC = [
    ("big.bin", TARGET * 1024 * 2 + 777),
    ("exact_part.bin", TARGET * 1024),
    ("small.txt", 300),
    ("tiny", 1),
    ("empty", 0),
    ("sub/dir/nested.dat", TARGET * 512 + 5),
]


def _write_tree(storage, root, seed=11):
    rng = np.random.default_rng(seed)
    storage.create_dir(root)
    for path, size in SPEC:
        data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        ensure_parent_dirs(storage, f"{root}/{path}")
        storage.write(f"{root}/{path}", data)


def test_pack_plain_matches_pallas_pack_interpret():
    """tests/test_tpu_branch.py's unaligned starts: the plain pack equals
    the Pallas pack kernel in interpret mode, row for row."""
    padded, rows = 2048, 8
    n_bytes = 64 << 10
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    slack = padded // 4 + 2048
    words2d = jpipeline.make_pad_words_fn(slack)(
        jax.device_put(data.reshape(-1, 128)))
    starts = np.array([0, 1, 3, 4095, 4096, 4097, 60000, 61337], np.int32)
    sizes = np.array([2048, 2047, 1, 2048, 512, 1025, 2048, 1000], np.int32)
    want = np.asarray(jpipeline.make_pack_fn(padded, rows)(
        words2d, jax.device_put(starts), jax.device_put(sizes)))
    got = tpack.pack(torch.from_numpy(data), torch.from_numpy(starts),
                     torch.from_numpy(sizes), padded)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert tpack.pack.LAUNCHES == 0


def test_pack_plain_zero_rows_and_batch_end():
    data = torch.arange(4096, dtype=torch.int64).to(torch.uint8)
    starts = torch.tensor([4090, 0, 7], dtype=torch.int32)
    sizes = torch.tensor([6, 0, 3], dtype=torch.int32)
    got = tpack.pack_plain(data, starts, sizes, 1024).numpy()
    b = got.view(np.uint8).reshape(3, 1024)
    np.testing.assert_array_equal(b[0, :6], np.arange(4090, 4096) % 256)
    assert not b[0, 6:].any() and not b[1].any()
    np.testing.assert_array_equal(b[2, :3], [7, 8, 9])


@pytest.mark.parametrize("target", [1024, 3072, 24576, 32768])
def test_size_classes_match_jax(target):
    cfg, jcfg = ChunkerConfig.from_target(target), \
        JChunkerConfig.from_target(target)
    cap = tpack.pow2_cap(cfg.padded_chunk)
    floor = tpack.class_floor(cfg)
    assert cap == jpipeline.pow2_cap(jcfg.padded_chunk)
    assert floor == jpipeline.class_floor(jcfg)
    sizes = np.unique(np.concatenate([
        np.arange(1, min(cfg.max_size, 4096) + 1),
        np.linspace(1, cfg.max_size, 997).astype(np.int64)]))
    np.testing.assert_array_equal(
        tpack.pow2_padded(sizes, cap, floor),
        jpipeline._pow2_padded(sizes, cap, floor))


def test_index_stream_matches_host_oracle():
    """Multi-part stream through DevicePartIndexer(device="cpu"): sizes
    and hashes per part equal the host chunker + BLAKE3 oracle, in
    submission order (tests/test_pipeline.py's parts, 3 lanes)."""
    rng = np.random.default_rng(3)
    indexer = pipeline.DevicePartIndexer(TARGET, "cpu", lanes=3)
    cfg = indexer.cfg
    P = indexer.part_bytes
    parts = [(i, rng.integers(0, 256, size=n, dtype=np.uint8))
             for i, n in enumerate([P, P // 2 + 13, 1, 700, P - 1,
                                    cfg.max_size, cfg.min_size, P // 3])]
    got = list(indexer.index_stream(iter(parts)))
    assert [t for t, _, _ in got] == [t for t, _ in parts]
    for (_, sizes, hashes), (_, data) in zip(got, parts):
        ends = cdc.chunk_part(data, cfg.min_size, cfg.avg_size, cfg.max_size)
        np.testing.assert_array_equal(
            sizes.astype(np.int64), np.diff(np.concatenate([[0], ends])))
        starts = np.concatenate([[0], ends[:-1]])
        want = jblake3.hash64_ranges(data, starts, ends - starts)
        if want is None:        # no native library: the scalar oracle
            want = np.array([jblake3.hash64(data[s:e].tobytes())
                             for s, e in zip(starts, ends)], np.uint64)
        np.testing.assert_array_equal(hashes, want)


@pytest.mark.parametrize("hash_kind", ["blake3", "blake2"])
def test_blake3_hashes_the_batch_without_pack(monkeypatch, hash_kind):
    """plan_hash makes one hash_chunks_device call of its hash (BLAKE3 or
    BLAKE2) on the resident batch and no pack call, with the digests in
    chunk order, equal to the host oracle."""
    import hashlib

    from longtail_tpu_torch.ops import blake2_kernel, blake3_kernel

    def blake2_64(data: bytes) -> int:
        return int.from_bytes(hashlib.blake2s(data, digest_size=8).digest(),
                              "little")

    calls = {"pack": 0, "blake3": 0, "blake2": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name, mod, attr in (("pack", tpack, "pack"),
                            ("blake3", blake3_kernel, "hash_chunks_device"),
                            ("blake2", blake2_kernel, "hash_chunks_device")):
        monkeypatch.setattr(mod, attr, counted(name, getattr(mod, attr)))
    rng = np.random.default_rng(8)
    ix = pipeline.DevicePartIndexer(TARGET, "cpu", lanes=2,
                                    hash_kind=hash_kind)
    parts = [(i, rng.integers(0, 256, n, dtype=np.uint8))
             for i, n in enumerate([ix.part_bytes, 5000])]
    got = list(ix.retire(ix.plan_hash(ix.submit_host(parts))))
    assert calls == {"pack": 0, "blake3": int(hash_kind == "blake3"),
                     "blake2": int(hash_kind == "blake2")}
    for (_, sizes, hashes), (_, data) in zip(got, parts):
        ends = np.cumsum(sizes.astype(np.int64))
        want = [(jblake3.hash64 if hash_kind == "blake3" else
                 blake2_64)(data[e - s:e].tobytes())
                for s, e in zip(sizes.astype(np.int64), ends)]
        np.testing.assert_array_equal(hashes, np.array(want, np.uint64))


def test_stage4_anchors_from_bins_equal_words_and_jax():
    """submit_compress / collect_compress on a 2-lane batch of 4 blocks:
    the anchors from the scan's bin-mins (compress=True) equal those from
    the resident words (compress=False) and the JAX package's
    make_fast_anchor_packed_fn over the same words, and the host LZ4
    assembler turns each block's anchors into a block that decodes."""
    rng = np.random.default_rng(41)
    P = TARGET * 1024
    tile = rng.integers(0, 256, 5000, np.uint8)
    parts = [(0, np.resize(tile, P)),
             (1, np.concatenate([rng.integers(0, 256, P // 2, np.uint8),
                                 np.resize(tile[:777], P // 3)]))]
    block = P // 2
    got = {}
    for compress in (True, False):
        ix = pipeline.DevicePartIndexer(TARGET, "cpu", lanes=2,
                                        compress=compress)
        entry = ix.plan_hash(ix.submit_host(parts), keep_words=True)
        got[compress] = ix.collect_compress(
            ix.submit_compress(entry, block_bytes=block))
        assert len(list(ix.retire(entry))) == 2
    flat = np.zeros(2 * P, np.uint8)
    flat[:P] = parts[0][1]
    flat[P:P + len(parts[1][1])] = parts[1][1]
    words = flat.view("<u4")
    want = jpipeline.DevicePartIndexer.collect_compress(
        jdm.make_fast_anchor_packed_fn(len(words), block // 4)(
            jax.device_put(words)))
    assert len(want) == 4
    for a, b, w in zip(got[True], got[False], want, strict=True):
        for x, y, z in zip(a, b, w):
            np.testing.assert_array_equal(x, z)
            np.testing.assert_array_equal(y, z)
    for k, (pos, ref) in enumerate(got[True]):
        src = flat[k * block:(k + 1) * block].tobytes()
        keep = pos < len(src)
        out = lz4.assemble_anchors(src, pos[keep], ref[keep])
        assert lz4.decompress(out, len(src)) == src
    assert len(got[True][0][0]) > 0


def test_version_index_bit_identical_to_jax_host_and_device():
    """create_version_index(device="cpu") == the JAX package's
    create_version_index with xp=np and with xp=jnp, byte for byte."""
    import jax.numpy as jnp

    st = MemStorage()
    _write_tree(st, "src")
    got = create_version_index(st, "src", target_chunk_size=TARGET,
                               device="cpu").to_bytes()
    assert got == j_create_version_index(
        st, "src", target_chunk_size=TARGET, xp=np).to_bytes()
    assert got == j_create_version_index(
        st, "src", target_chunk_size=TARGET, xp=jnp).to_bytes()


def test_upsync_then_host_downsync_reproduces_tree(tmp_path):
    fs = FSStorage()
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    _write_tree(fs, src, seed=5)
    store = CompressBlockStore(FSBlockStore(fs, str(tmp_path / "store")))
    vi, vsi = api.upsync(fs, src, store, target_chunk_size=TARGET,
                         device="cpu")
    assert vsi.block_count > 0
    japi.downsync(CompressBlockStore(FSBlockStore(fs, str(tmp_path /
                                                          "store"))),
                  fs, out, vi, min_block_usage_percent=0)
    for path, size in SPEC:
        a = open(os.path.join(src, path), "rb").read()
        b = open(os.path.join(out, path), "rb").read()
        assert len(a) == size and a == b, path


def test_cli_upsync_host_path_writes_the_hosts_index(tmp_path):
    fs = FSStorage()
    src = str(tmp_path / "src")
    _write_tree(fs, src, seed=6)
    lvi = str(tmp_path / "v.lvi")
    rc = cli.main(["upsync", "--storage-uri", str(tmp_path / "store"),
                   "--source-path", src, "--target-path", lvi,
                   "--target-chunk-size", str(TARGET),
                   "--compression-algorithm", "lz4", "--device", "host"])
    assert rc == 0
    want = j_create_version_index(fs, src, target_chunk_size=TARGET, xp=np,
                                  asset_tags=None)
    got = VersionIndex.from_bytes(open(lvi, "rb").read())
    np.testing.assert_array_equal(got.chunk_hashes, want.chunk_hashes)
    np.testing.assert_array_equal(got.asset_sizes, want.asset_sizes)


@pytest.mark.parametrize("argv,exc", [
    (["pack", "--source-path", "a", "--target-path", "b.la", "--device"],
     RuntimeError),
    (["upsync", "--storage-uri", "s", "--source-path", "a",
      "--target-path", "b.lvi", "--device", "--hash-algorithm", "meow"],
     RuntimeError),
    (["upsync", "--storage-uri", "s", "--source-path", "a",
      "--target-path", "b.lvi", "--device"], RuntimeError),
    (["upsync", "--storage-uri", "s", "--source-path", "a",
      "--target-path", "b.lvi"], RuntimeError),
    (["upsync", "--storage-uri", "s", "--source-path", "a",
      "--target-path", "b.lvi", "--hash-algorithm", "meow"],
     RuntimeError),
    (["downsync", "--storage-uri", "s", "--source-path", "a.lvi",
      "--target-path", "b", "--device"], SystemExit),
])
def test_cli_device_outside_the_port_raises(tmp_path, monkeypatch, argv, exc):
    """The card is the default of upsync and pack, meow included (its
    block codecs run there): without a card they raise before any work;
    downsync has no --device, as in the JAX CLI."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("a")
    with pytest.raises(exc):
        cli.main(argv)
    assert not os.path.exists("b.la") and not os.path.exists("b.lvi")


def _write_prose_tree(root, seed=31):
    """Compressible files (words from a small vocabulary, one with a zero
    run) large enough for the device codec route, and a small file."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 9), np.uint8))
             for _ in range(300)]
    for k, (rel, n) in enumerate((("a/one.txt", 700_000),
                                  ("a/b/two.txt", 300_000),
                                  ("small.txt", 5000))):
        data = b" ".join(vocab[i] for i in rng.integers(0, 300, n // 3))
        if k == 0:
            data = data[:200_000] + bytes(30_000) + data[200_000:]
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data[:n])


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _jax_device_codecs(monkeypatch, on: bool):
    """The JAX package's device codec switches, set for this test only
    (its cli._xp would leave them set for later tests)."""
    from longtail_tpu.ops.compression_registry import Lz4Codec, ZstdCodec

    monkeypatch.setattr(Lz4Codec, "use_device", on)
    monkeypatch.setattr(ZstdCodec, "use_device", on)


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_cli_meow_upsync_writes_the_jax_packages_device_upsync(
        tmp_path, monkeypatch, codec):
    """upsync --device cpu --hash-algorithm meow: chunk+hash on the host
    path, blocks through the device codecs' plain versions; the .lvi and
    every block file equal the JAX package's upsync --device --hash-
    algorithm meow on the CPU (xp=jnp with its device codecs)."""
    import jax.numpy as jnp

    from longtail_tpu.formats import constants as JC

    src = str(tmp_path / "src")
    _write_prose_tree(src)
    lvi = str(tmp_path / "v.lvi")
    rc = cli.main(["upsync", "--storage-uri", str(tmp_path / "port"),
                   "--source-path", src, "--target-path", lvi,
                   "--target-chunk-size", str(TARGET), "--target-block-size",
                   str(256 << 10), "--hash-algorithm", "meow",
                   "--compression-algorithm", codec, "--device", "cpu"])
    assert rc == 0
    _jax_device_codecs(monkeypatch, True)
    tag = {"zstd": JC.COMPRESSION_TYPE_ZSTD_DEFAULT,
           "lz4": JC.COMPRESSION_TYPE_LZ4_DEFAULT}[codec]
    fs = FSStorage()
    jvi, _ = japi.upsync(
        fs, src, CompressBlockStore(FSBlockStore(fs, str(tmp_path / "jax"))),
        target_chunk_size=TARGET, target_block_size=256 << 10,
        hash_identifier=JC.HASH_TYPE_MEOW, compression_tag=tag, xp=jnp)
    assert open(lvi, "rb").read() == jvi.to_bytes()
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    blocks = [p for p in want if p.endswith(".lrb")]
    assert len(blocks) >= 3 and sorted(got) == sorted(want)
    for p in blocks:
        assert got[p] == want[p], p
    # the device codecs ran: the host codecs write other bytes
    _jax_device_codecs(monkeypatch, False)
    japi.upsync(fs, src, CompressBlockStore(FSBlockStore(
        fs, str(tmp_path / "host"))), target_chunk_size=TARGET,
        target_block_size=256 << 10, hash_identifier=JC.HASH_TYPE_MEOW,
        compression_tag=tag)
    host = _tree(tmp_path / "host")
    assert any(host[p] != want[p] for p in blocks)


def test_cli_pack_device_cpu_writes_the_jax_packages_archive(
        tmp_path, monkeypatch):
    """pack --device cpu (zstd, the default) writes the .la of the JAX
    package's pack_archive(xp=jnp) with its device codecs byte for byte
    (one worker: blocks land in the archive in order), and unpack
    rebuilds the tree."""
    import jax.numpy as jnp

    from longtail_tpu.formats import constants as JC
    from longtail_tpu.stores.archiveblockstore import (
        pack_archive as j_pack_archive,
    )

    src = str(tmp_path / "src")
    _write_prose_tree(src)
    la = str(tmp_path / "a.la")
    rc = cli.main(["--workers", "1", "pack", "--source-path", src,
                   "--target-path", la, "--target-chunk-size", str(TARGET),
                   "--target-block-size", str(256 << 10), "--device", "cpu"])
    assert rc == 0
    _jax_device_codecs(monkeypatch, True)
    jla = str(tmp_path / "j.la")
    j_pack_archive(FSStorage(), src, jla, target_chunk_size=TARGET,
                   target_block_size=256 << 10,
                   compression_tag=JC.COMPRESSION_TYPE_ZSTD_DEFAULT,
                   workers=1, xp=jnp)
    assert open(la, "rb").read() == open(jla, "rb").read()
    _jax_device_codecs(monkeypatch, False)
    hla = str(tmp_path / "h.la")
    j_pack_archive(FSStorage(), src, hla, target_chunk_size=TARGET,
                   target_block_size=256 << 10,
                   compression_tag=JC.COMPRESSION_TYPE_ZSTD_DEFAULT,
                   workers=1)
    assert open(hla, "rb").read() != open(jla, "rb").read()
    out = str(tmp_path / "out")
    assert cli.main(["unpack", "--source-path", la, "--target-path",
                     out]) == 0
    assert _tree(out) == _tree(src)


def test_downsync_over_a_stale_target_scans_it_on_the_device(
        tmp_path, monkeypatch):
    """api.downsync over a stale target (one file edited, one removed)
    re-indexes it on its device: with device="cpu" the target's index
    equals device=None's and the JAX package's xp=jnp scan, and each
    downsync rebuilds the source."""
    import jax.numpy as jnp

    from longtail_tpu import api as japi_mod

    fs, jfs = TFSStorage(), FSStorage()
    src = str(tmp_path / "src")
    _write_tree(fs, src, seed=4)
    store_dir = str(tmp_path / "store")
    vi, _ = api.upsync(fs, src, TCompressBlockStore(TFSBlockStore(
        fs, store_dir)), target_chunk_size=TARGET, device=None)

    def stale(name):
        target = str(tmp_path / name)
        _write_tree(fs, target, seed=4)
        data = bytearray(open(os.path.join(target, "big.bin"), "rb").read())
        data[1000:1006] = b"edited"
        open(os.path.join(target, "big.bin"), "wb").write(bytes(data))
        os.remove(os.path.join(target, "tiny"))
        return target

    scans = {}

    def capture(mod, key):
        real = mod.create_version_index

        def scan(*a, **kw):
            index = real(*a, **kw)
            scans[key] = (kw.get("device", kw.get("xp")), index.to_bytes())
            return index
        monkeypatch.setattr(mod, "create_version_index", scan)

    capture(api, "port")
    for device in ("cpu", None):
        target = stale(f"t_{device}")
        api.downsync(TCompressBlockStore(TFSBlockStore(fs, store_dir)), fs,
                     target, vi, workers=2, device=device)
        assert _tree(target) == _tree(src)
        assert scans["port"][0] == device
        scans[device] = scans.pop("port")[1]
    capture(japi_mod, "jax")
    target = stale("t_jax")
    japi.downsync(CompressBlockStore(FSBlockStore(jfs, store_dir)), jfs,
                  target, VersionIndex.from_bytes(vi.to_bytes()), workers=2,
                  min_block_usage_percent=0, xp=jnp)
    assert _tree(target) == _tree(src)
    assert scans["cpu"] == scans[None] == scans["jax"][1]


def test_downsync_into_a_fresh_folder_touches_no_device(tmp_path):
    """A downsync into a folder that does not exist needs no card: the
    default device is resolved only when a target is scanned."""
    fs = TFSStorage()
    src = str(tmp_path / "src")
    _write_tree(fs, src, seed=9)
    store = TCompressBlockStore(TFSBlockStore(fs, str(tmp_path / "store")))
    vi, _ = api.upsync(fs, src, store, target_chunk_size=TARGET, device=None)
    out = str(tmp_path / "out")
    api.downsync(store, fs, out, vi, workers=2)
    assert _tree(out) == _tree(src)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.downsync(store, fs, out, vi, workers=2)


def test_cuda_without_a_card_raises(tmp_path):
    assert not torch.cuda.is_available()
    fs = FSStorage()
    store = FSBlockStore(fs, str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.upsync(fs, str(tmp_path), store, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.DevicePartIndexer(TARGET, "cuda")


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(_kernels, "_LIB", None)
    monkeypatch.setattr(_kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.load()


def test_require_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.require("x", torch.zeros(4, dtype=torch.int32), torch.int32)


def _foreign(name: str) -> bool:
    """A module the port must not load: jax, or the JAX package."""
    return name.split(".")[0] in ("jax", "longtail_tpu")


def test_import_leaves_jax_out(tmp_path):
    """Every module of the port, imported in a fresh interpreter
    (tests/conftest.py imports jax in this process), then a CPU upsync and
    a downsync through the port's api: no module of jax or of the JAX
    package is loaded."""
    code = f"""
import importlib, os, pkgutil, sys
import longtail_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):
    importlib.import_module(m.name)
assert 'longtail_tpu_torch.ops.zstd_device' in sys.modules
from longtail_tpu_torch import api
from longtail_tpu_torch.stores.compressblockstore import CompressBlockStore
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore
from longtail_tpu_torch.stores.storage import FSStorage
root = {str(tmp_path)!r}
os.makedirs(root + '/src/sub')
for name, size in (('a.bin', 300000), ('sub/b.txt', 5000), ('e', 0)):
    open(root + '/src/' + name, 'wb').write(os.urandom(size))
fs = FSStorage()
store = CompressBlockStore(FSBlockStore(fs, root + '/store'), device='cpu')
vi, _ = api.upsync(fs, root + '/src', store, target_chunk_size=1024,
                   device='cpu', workers=2)
api.downsync(store, fs, root + '/out', vi, workers=2)
for name in ('a.bin', 'sub/b.txt', 'e'):
    assert open(root + '/out/' + name, 'rb').read() == \
        open(root + '/src/' + name, 'rb').read(), name
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'longtail_tpu'))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=300)


def test_no_jax_import_in_the_port():
    """No import statement of the port, of chip_smoke.py, of
    bench_torch.py or of tools/profile_torch_codecs.py names jax or the
    JAX package."""
    import ast

    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "bench_torch.py"),
             os.path.join(REPO, "tools", "profile_torch_codecs.py")]
    for d, _, files in os.walk(os.path.join(REPO, "longtail_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    hits = []
    for path in paths:
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif isinstance(node, ast.Call) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    getattr(node.func, "attr",
                            getattr(node.func, "id", "")) in (
                                "import_module", "__import__"):
                names = [str(node.args[0].value)]
            else:
                continue
            hits += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                     for n in names if _foreign(n)]
    assert len(paths) > 60 and not hits, hits
