"""The round trips, reference depth, control-plane scale and reference
interop of tests/test_roundtrip.py, tests/test_reference_depth.py,
tests/test_scale.py and tests/test_interop.py held between the JAX
package and the port (api, store_algebra, change, diff, dedup, write,
the formats): each scenario runs in both packages from one seed and
returns the .lvi/.lsi bytes, block sets, plans and trees it produced,
which must be equal."""

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import numpy as np
import pytest
import torch

from tests.torch_sides import (
    JAX,
    PORT,
    SIDES,
    block_hashes,
    downsync,
    make_source,
    read_tree,
    same,
    upsync,
)

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).parent
GOLDEN = HERE / "testdata" / "ref_golden"
SAMPLE = HERE / "testdata" / "sample_folder"
REF_BIN = os.environ.get("LONGTAIL_REF_BIN", "/tmp/refbuild/mybuild/longtail")


def compressed_store(side, storage, root="store"):
    return side.compressblockstore.CompressBlockStore(
        side.fsblockstore.FSBlockStore(storage, root))


# ---------------------------------------------------------------------------
# round trips (test_roundtrip.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["none", "lz4"])
def test_upsync_downsync_roundtrip_mem(compression):
    def scenario(side):
        tag = {"none": side.C.COMPRESSION_TYPE_NONE,
               "lz4": side.C.COMPRESSION_TYPE_LZ4_DEFAULT}[compression]
        storage = side.storage.MemStorage()
        storage.create_dir("src")
        files = make_source(storage, "src", np.random.default_rng(11))
        store = compressed_store(side, storage)
        vi, vsi = upsync(side, storage, "src", store, target_chunk_size=2048,
                         compression_tag=tag, workers=2)
        assert vi.asset_count == len(files) + 3  # bin/, bin/sub/, strange/
        assert vsi.chunk_count >= vi.chunk_count
        downsync(side, store, storage, "dst", vi, workers=2)
        assert read_tree(side, storage, "dst") == files
        return (vi.to_bytes(), vsi.to_bytes(),
                side.api.validate_version(store, vi).ok)

    assert same(scenario)[2]


def test_incremental_sync_only_fetches_missing(tmp_path):
    """Change, add and remove a file: the second downsync fetches the
    same few blocks in both packages."""
    def scenario(side):
        rng = np.random.default_rng(5)
        (tmp_path / side.name).mkdir()
        storage = side.storage.FSStorage(str(tmp_path / side.name))
        storage.create_dir("src")
        files = make_source(storage, "src", rng)
        fs_store = side.fsblockstore.FSBlockStore(storage, "store")
        store = side.compressblockstore.CompressBlockStore(fs_store)
        vi1, _ = upsync(side, storage, "src", store, target_chunk_size=2048,
                        workers=1)
        downsync(side, store, storage, "dst", vi1, workers=1)
        assert read_tree(side, storage, "dst") == files

        storage.write("src/readme.txt", b"changed content!\n" * 4)
        storage.write("src/bin/new.bin",
                      rng.integers(0, 256, 5_000, dtype=np.uint8).tobytes())
        storage.remove_file("src/empty.txt")
        files2 = read_tree(side, storage, "src")

        vi2, _ = upsync(side, storage, "src", store, target_chunk_size=2048,
                        workers=1)
        gets_before = fs_store.get_stats().get_stored_block_count
        downsync(side, store, storage, "dst", vi2, workers=1)
        gets = fs_store.get_stats().get_stored_block_count - gets_before
        assert read_tree(side, storage, "dst") == files2
        total = fs_store.get_existing_content(vi2.chunk_hashes).block_count
        return vi1.to_bytes(), vi2.to_bytes(), gets, total

    _, _, gets, total = same(scenario)
    assert 0 < gets < total


def test_downsync_into_dirty_target():
    def scenario(side):
        storage = side.storage.MemStorage()
        storage.create_dir("src")
        files = make_source(storage, "src", np.random.default_rng(9))
        store = compressed_store(side, storage)
        vi, _ = upsync(side, storage, "src", store, target_chunk_size=2048,
                       workers=1)
        storage.create_dir("dst")
        storage.write("dst/stale.bin", b"junk" * 100)
        storage.create_dir("dst/bin")
        storage.write("dst/bin/a.dat", b"old")
        downsync(side, store, storage, "dst", vi, workers=1)
        got = read_tree(side, storage, "dst")
        assert got == files
        return vi.to_bytes(), got

    same(scenario)


def test_store_index_persist_and_rescan():
    """The .lsi a store writes, read back by a fresh store and rebuilt by
    a scan of the .lrb files once deleted: the same in both."""
    def scenario(side):
        storage = side.storage.MemStorage()
        storage.create_dir("src")
        make_source(storage, "src", np.random.default_rng(2))
        store = side.fsblockstore.FSBlockStore(storage, "store")
        vi, _ = upsync(side, storage, "src", store, target_chunk_size=2048,
                       compression_tag=0, workers=1)
        lsi = storage.read("store/store.lsi")
        validate = side.store_algebra.validate_store
        idx = side.fsblockstore.FSBlockStore(
            storage, "store").get_existing_content(vi.chunk_hashes)
        storage.remove_file("store/store.lsi")
        idx3 = side.fsblockstore.FSBlockStore(
            storage, "store").get_existing_content(vi.chunk_hashes)
        return (lsi, validate(idx, vi).ok, validate(idx3, vi).ok,
                block_hashes(idx), block_hashes(idx3))

    _, ok, ok3, blocks, blocks3 = same(scenario)
    assert ok and ok3 and blocks == blocks3


def test_validate_missing_content():
    def scenario(side):
        storage = side.storage.MemStorage()
        storage.create_dir("src")
        storage.write("src/a.bin", b"some data here")
        store = side.fsblockstore.FSBlockStore(storage, "store")
        vi, _ = upsync(side, storage, "src", store, compression_tag=0,
                       workers=1)
        for sub in storage.list_dir("store/chunks"):
            for name in storage.list_dir(f"store/chunks/{sub}"):
                storage.remove_file(f"store/chunks/{sub}/{name}")
        storage.remove_file("store/store.lsi")
        result = side.api.validate_version(
            side.fsblockstore.FSBlockStore(storage, "store"), vi)
        return result.ok, sorted(int(h) for h in result.missing_chunk_hashes)

    ok, missing = same(scenario)
    assert not ok and missing


# ---------------------------------------------------------------------------
# reference depth (test_reference_depth.py)
# ---------------------------------------------------------------------------

def test_case_collision_paths():
    """lowercase.txt and UPPERCASE.txt over a target holding the
    opposite-case names come back exactly."""
    def scenario(side):
        st = side.storage.MemStorage()
        files = {
            "local1/lowercase.txt": b"This is the first test string which "
                                    b"is fairly long and should - "
                                    b"reconstructed properly, than you "
                                    b"very much",
            "local1/UPPERCASE.txt": b"Short string",
        }
        st.create_dir("src")
        for p, data in files.items():
            side.storage.ensure_parent_dirs(st, f"src/{p}")
            st.write(f"src/{p}", data)
        store = side.fsblockstore.FSBlockStore(st, "store")
        vi, _ = upsync(side, st, "src", store, target_chunk_size=1024,
                       workers=2)
        st.create_dir("dst")
        side.storage.ensure_parent_dirs(st, "dst/local1/LOWERCASE.txt")
        st.write("dst/local1/LOWERCASE.txt", b"other content A")
        st.write("dst/local1/uppercase.txt", b"other content B")
        downsync(side, store, st, "dst", vi, workers=2)
        got = read_tree(side, st, "dst")
        assert got == files
        return vi.to_bytes(), got

    same(scenario)


@pytest.mark.parametrize("kind", ["mem", "fs"])
def test_out_of_order_and_sparse_writes(kind):
    """A fresh file written second half first, positional writes, the
    whole-file replace at offset 0, and scattered ranges with gaps: what
    each read returns, in both packages."""
    def scenario(side):
        st = side.storage.MemStorage() if kind == "mem" else \
            side.storage.FSStorage(tempfile.mkdtemp(prefix="lt_ooo_"))
        n = 2048
        second = bytes([255]) * (n // 2)
        first = bytes([127]) * (n // 2)
        seen = []
        st.write("ooo.bin", second, offset=n // 2)
        st.write_ranges("ooo.bin", n, [(0, first)])
        seen += [st.read("ooo.bin"), st.get_size("ooo.bin")]
        st.write("ooo.bin", b"\x01", offset=1)
        seen += [st.get_size("ooo.bin"), st.read("ooo.bin")]
        st.write("ooo.bin", b"xy")
        seen.append(st.read("ooo.bin"))
        st.write_ranges("sparse.bin", 2000,
                        [(1500, b"BB"), (0, b"AA"), (700, b"CC")])
        seen.append(st.read("sparse.bin"))
        if kind == "fs":
            shutil.rmtree(st.base)
        return seen

    seen = same(scenario)
    assert seen[0] == bytes([127]) * 1024 + bytes([255]) * 1024
    assert seen[1] == seen[2] == 2048 and seen[4] == b"xy"
    sparse = seen[5]
    assert (sparse[0:2], sparse[700:702], sparse[1500:1502]) == \
        (b"AA", b"CC", b"BB") and len(sparse) == 2000
    assert sparse[2:700] == bytes(698) and sparse[1502:] == bytes(498)


def test_large_single_asset_roundtrip():
    """A single asset over 4 GiB through upsync and downsync in both
    packages: the same .lvi, and the downsync's sha256 equal to the
    source's.  The port runs its host path here (its plain kernels would
    take most of an hour on 4 GiB); chip_smoke.py phase 16 runs this
    asset through the card."""
    if not os.environ.get("LT_TESTS_LARGE"):
        pytest.skip("4 GiB disk/time; set LT_TESTS_LARGE=1")
    base = tempfile.mkdtemp(prefix="lt_large_")
    try:
        path = os.path.join(base, "src", "huge.bin")
        os.makedirs(os.path.dirname(path))
        size = (4 << 30) + 4097
        tile = np.arange(1 << 18, dtype=np.uint32)
        want = hashlib.sha256()
        with open(path, "wb") as f:
            off = 0
            while off < size:
                block = ((tile + np.uint32(off >> 20)) ^ np.uint32(0xA5))
                chunk = block.tobytes()[: min(1 << 20, size - off)]
                f.write(chunk)
                want.update(chunk)
                off += len(chunk)

        def scenario(side):
            st = side.storage.FSStorage(base)
            store = side.fsblockstore.FSBlockStore(st, f"store_{side.name}")
            kwargs = {"device": None} if side is PORT else {}
            vi, _ = side.api.upsync(
                st, "src", store, workers=4,
                compression_tag=side.C.COMPRESSION_TYPE_NONE, **kwargs)
            assert int(vi.asset_sizes.max()) == size
            dst = f"dst_{side.name}"
            downsync(side, store, st, dst, vi, workers=4)
            got = hashlib.sha256()
            with open(os.path.join(base, dst, "huge.bin"), "rb") as f:
                while b := f.read(1 << 22):
                    got.update(b)
            shutil.rmtree(os.path.join(base, dst))
            shutil.rmtree(os.path.join(base, f"store_{side.name}"))
            return vi.to_bytes(), got.hexdigest()

        assert same(scenario)[1] == want.hexdigest()
    finally:
        shutil.rmtree(base, ignore_errors=True)


def test_memstorage_rename_posix_semantics():
    """MemStorage's rename moves directory children, refuses to clobber a
    non-empty directory or put a file over a directory, and replaces
    files and empty directories, in both packages."""
    def scenario(side):
        st = side.storage.MemStorage()
        st.create_dir("d")
        st.create_dir("d/sub")
        st.write("d/a.txt", b"a")
        st.write("d/sub/b.txt", b"b")
        out = []

        def attempt(src, dst):
            try:
                st.rename(src, dst)
                out.append("ok")
            except Exception as e:  # noqa: BLE001 - the type is compared
                out.append(type(e).__name__)

        attempt("d", "e")
        out += [st.read("e/a.txt"), st.read("e/sub/b.txt"), st.is_dir("d")]
        st.write("x", b"1")
        st.write("y", b"2")
        attempt("x", "y")
        out.append(st.read("y"))
        st.write("f", b"f")
        attempt("f", "e")
        st.create_dir("g")
        attempt("g", "e")
        st.create_dir("empty")
        attempt("g", "empty")
        out += [st.is_dir("empty"), st.is_dir("g")]
        return out

    out = same(scenario)
    assert out[:5] == ["ok", b"a", b"b", False, "ok"] and out[5] == b"1"
    assert out[6] != "ok" and out[7] != "ok" and out[8:] == ["ok", True,
                                                               False]


# ---------------------------------------------------------------------------
# control-plane scale (test_scale.py)
# ---------------------------------------------------------------------------

def synth_version(side, n_assets: int, chunks_per_asset: int):
    n_chunks = n_assets * chunks_per_asset
    rng = np.random.default_rng(3)
    names = bytearray()
    offs = []
    for a in range(n_assets):
        offs.append(len(names))
        names += f"dir{a % 97}/file{a}.bin".encode() + b"\0"
    return side.version_index.VersionIndex(
        hash_identifier=0x626C6B33,
        target_chunk_size=32768,
        path_hashes=rng.integers(0, 2**63, n_assets, dtype=np.uint64),
        content_hashes=rng.integers(0, 2**63, n_assets, dtype=np.uint64),
        asset_sizes=np.full(n_assets, chunks_per_asset * 1000, np.uint64),
        asset_chunk_counts=np.full(n_assets, chunks_per_asset, np.uint32),
        asset_chunk_index_starts=np.arange(
            0, n_chunks, chunks_per_asset, dtype=np.uint32),
        asset_chunk_indexes=np.arange(n_chunks, dtype=np.uint32),
        chunk_hashes=rng.permutation(
            np.arange(1, n_chunks + 1, dtype=np.uint64)),
        chunk_sizes=np.full(n_chunks, 1000, np.uint32),
        chunk_tags=np.zeros(n_chunks, np.uint32),
        name_offsets=np.asarray(offs, dtype=np.uint32),
        permissions=np.full(n_assets, 0o644, np.uint16),
        name_data=bytes(names),
    )


def synth_store(side, vi, chunks_per_block: int):
    n = vi.chunk_count
    n_blocks = -(-n // chunks_per_block)
    counts = np.full(n_blocks, chunks_per_block, np.uint32)
    counts[-1] = n - chunks_per_block * (n_blocks - 1)
    offsets = np.cumsum(counts, dtype=np.uint32) - counts
    return side.store_index.StoreIndex(
        hash_identifier=vi.hash_identifier,
        block_hashes=np.arange(1, n_blocks + 1, dtype=np.uint64),
        chunk_hashes=vi.chunk_hashes.copy(),
        block_chunks_offsets=offsets,
        block_chunk_counts=counts,
        block_tags=np.zeros(n_blocks, np.uint32),
        chunk_sizes=vi.chunk_sizes.copy(),
    )


@pytest.fixture(scope="module")
def million():
    """Each package's 1M-chunk version (4000 assets) and its store of
    512-chunk blocks, by package name."""
    out = {}
    for side in SIDES:
        vi = synth_version(side, n_assets=4000, chunks_per_asset=250)
        out[side.name] = vi, synth_store(side, vi, chunks_per_block=512)
    return out


def port_cpu_seconds(fn, *args):
    """fn(*args) and its CPU time (immune to co-tenants), timed on the
    port only: the JAX package's own test bounds its time."""
    t0 = time.process_time()
    out = fn(*args)
    return out, time.process_time() - t0


def plan_bytes(per_block) -> bytes:
    """A block write plan as bytes: per block in order, its writes
    sorted (asset, file offset, block offset, size)."""
    out = []
    for b in sorted(per_block):
        rows = np.stack([np.asarray(a, np.int64) for a in per_block[b]])
        rows = rows[:, np.lexsort(rows[::-1])]
        out.append(np.int64(b).tobytes() + rows.tobytes())
    return b"".join(out)


def test_asset_part_lookup_scales(million):
    def scenario(side):
        vi, _ = million[side.name]
        lookup, dt = port_cpu_seconds(side.write.create_asset_part_lookup, vi)
        if side is PORT:
            assert dt < 3.0, f"asset part lookup took {dt:.2f}s CPU"
        assert len(lookup) == vi.chunk_count
        return (lookup[int(vi.chunk_hashes[12345])],
                hashlib.sha256(np.concatenate(
                    [lookup.hashes.astype(np.int64), lookup.asset,
                     lookup.offset, lookup.size]).tobytes()).hexdigest())

    assert same(scenario)[0][2] == 1000


def test_block_write_infos_scale(million):
    def scenario(side):
        vi, si = million[side.name]
        per_block, dt = port_cpu_seconds(
            side.change._build_block_write_infos, vi, si,
            np.arange(vi.asset_count, dtype=np.int64))
        if side is PORT:
            assert dt < 3.0, f"block write plan took {dt:.2f}s CPU"
        assert len(per_block) == si.block_count
        assert sum(len(v[0]) for v in per_block.values()) == vi.chunk_count
        return hashlib.sha256(plan_bytes(per_block)).hexdigest()

    same(scenario)


def test_block_write_infos_matches_oracle():
    """The vectorised plan on a small instance, equal in both packages
    and to test_scale.py's dict/loop oracle."""
    def scenario(side):
        vi = synth_version(side, n_assets=13, chunks_per_asset=7)
        si = synth_store(side, vi, chunks_per_block=5)
        return plan_bytes(side.change._build_block_write_infos(
            vi, si, np.arange(vi.asset_count, dtype=np.int64))), vi, si

    want_plan, _, _ = scenario(JAX)
    got_plan, vi, si = scenario(PORT)
    assert got_plan == want_plan
    chunk_to_block = {}
    for b in range(si.block_count):
        hashes, sizes = si.block_chunks(b)
        off = 0
        for h, s in zip(hashes, sizes):
            chunk_to_block.setdefault(int(h), (b, off))
            off += int(s)
    oracle = {}
    for a in range(vi.asset_count):
        fo = 0
        for ci in vi.asset_chunks(a):
            h = int(vi.chunk_hashes[ci])
            b, boff = chunk_to_block[h]
            oracle.setdefault(b, []).append((a, fo, boff,
                                             int(vi.chunk_sizes[ci])))
            fo += int(vi.chunk_sizes[ci])
    assert got_plan == plan_bytes({b: tuple(np.array(w).T)
                                   for b, w in oracle.items()})


def test_required_chunk_hashes_scale(million):
    def scenario(side):
        vi, _ = million[side.name]
        z = np.zeros(0, np.int64)
        diff = side.diff.VersionDiff(
            source_removed_asset_indexes=z,
            target_added_asset_indexes=np.arange(vi.asset_count,
                                                 dtype=np.int64),
            source_content_modified_asset_indexes=z,
            target_content_modified_asset_indexes=z,
            source_permissions_modified_asset_indexes=z,
            target_permissions_modified_asset_indexes=z,
        )
        req, dt = port_cpu_seconds(side.diff.get_required_chunk_hashes,
                                   vi, diff)
        if side is PORT:
            assert dt < 3.0, f"required chunk hashes took {dt:.2f}s"
        assert len(req) == vi.chunk_count
        assert req[0] == vi.chunk_hashes[int(vi.asset_chunks(0)[0])]
        return hashlib.sha256(np.asarray(req, np.uint64)
                              .tobytes()).hexdigest()

    same(scenario)


def test_existing_store_index_scales(million):
    def scenario(side):
        vi, si = million[side.name]
        sub, dt = port_cpu_seconds(side.dedup.get_existing_store_index,
                                   si, vi.chunk_hashes[: 200_000])
        if side is PORT:
            assert dt < 10.0, f"existing store index took {dt:.2f}s"
        assert sub.block_count > 0
        return hashlib.sha256(sub.to_bytes()).hexdigest()

    same(scenario)


# ---------------------------------------------------------------------------
# the reference C library's artifacts (test_interop.py)
# ---------------------------------------------------------------------------

def files_under(root: pathlib.Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        out[rel + "/" if p.is_dir() else rel] = \
            None if p.is_dir() else p.read_bytes()
    return out


def test_reference_version_index_parses():
    def scenario(side):
        vi = side.version_index.VersionIndex.from_bytes(
            (GOLDEN / "ref.lvi").read_bytes())
        return vi.asset_count, vi.chunk_count, sorted(vi.paths()), \
            vi.to_bytes()

    assets, chunks, paths, _ = same(scenario)
    assert (assets, chunks) == (20, 9) and "JustDifferent.txt" in paths
    assert any(not p.isascii() for p in paths)


def test_reference_store_downsync_bit_exact(tmp_path):
    def scenario(side):
        vi = side.version_index.VersionIndex.from_bytes(
            (GOLDEN / "ref.lvi").read_bytes())
        store = compressed_store(side, side.storage.FSStorage(),
                                 str(GOLDEN / "refstore"))
        target = tmp_path / side.name
        downsync(side, store, side.storage.FSStorage(), str(target), vi)
        return files_under(target)

    assert same(scenario) == files_under(SAMPLE)


def test_reference_store_lsi_parses():
    def scenario(side):
        si = side.store_index.StoreIndex.from_bytes(
            (GOLDEN / "refstore" / "store.lsi").read_bytes())
        return si.block_count, si.chunk_count, si.to_bytes()

    blocks, chunks, _ = same(scenario)
    assert blocks >= 1 and chunks == 9


def test_reference_archive_unpack_bit_exact(tmp_path):
    def scenario(side):
        target = tmp_path / side.name
        kwargs = {"device": "cpu"} if side is PORT else {}
        side.archiveblockstore.unpack_archive(
            side.storage.FSStorage(), str(GOLDEN / "ref.la"), str(target),
            **kwargs)
        return files_under(target)

    assert same(scenario) == files_under(SAMPLE)


def cli_device(side) -> list:
    return ["--device", "cpu"] if side is PORT else []


def test_reference_binary_reads_our_output(tmp_path):
    """Both packages' upsync and pack outputs are consumed by the real
    reference CLI, which reconstructs the same tree from each."""
    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary not built on this machine")

    def scenario(side):
        base = tmp_path / side.name
        store, lvi, la = base / "store", base / "v.lvi", base / "v.la"
        assert side.cli.main(["upsync", "--storage-uri", str(store),
                              "--source-path", str(SAMPLE),
                              "--target-path", str(lvi),
                              "--compression-algorithm", "zstd",
                              "--target-chunk-size", "4096",
                              *cli_device(side)]) == 0
        assert side.cli.main(["pack", "--source-path", str(SAMPLE),
                              "--target-path", str(la),
                              "--compression-algorithm", "zstd",
                              "--target-chunk-size", "4096",
                              *cli_device(side)]) == 0
        trees = []
        for args, out in [
                (["downsync", "--source-path", str(lvi),
                  "--target-path", str(base / "o1"),
                  "--storage-uri", str(store)], base / "o1"),
                (["unpack", "--source-path", str(la),
                  "--target-path", str(base / "o2")], base / "o2")]:
            subprocess.run([REF_BIN] + args, check=True, capture_output=True)
            trees.append(files_under(out))
        return lvi.read_bytes(), trees

    _, trees = same(scenario)
    assert trees == [files_under(SAMPLE)] * 2


@pytest.mark.parametrize("algo", ["blake3", "blake2", "meow"])
def test_version_index_hash_parity_with_reference(tmp_path, algo):
    """Both packages' upsync and the reference's give the same chunk,
    path and content hashes for every --hash-algorithm."""
    if not os.path.exists(REF_BIN):
        pytest.skip("reference binary not built on this machine")
    refs = tmp_path / "ref.lvi"
    subprocess.run(
        [REF_BIN, "upsync", "--source-path", str(SAMPLE),
         "--target-path", str(refs), "--storage-uri", str(tmp_path / "s2"),
         "--hash-algorithm", algo, "--target-chunk-size", "4096"],
        check=True, capture_output=True)

    def scenario(side):
        ours = tmp_path / f"{side.name}.lvi"
        assert side.cli.main(["upsync", "--storage-uri",
                              str(tmp_path / f"s_{side.name}"),
                              "--source-path", str(SAMPLE),
                              "--target-path", str(ours),
                              "--hash-algorithm", algo,
                              "--target-chunk-size", "4096",
                              *cli_device(side)]) == 0
        a = side.version_index.VersionIndex.from_bytes(ours.read_bytes())
        b = side.version_index.VersionIndex.from_bytes(refs.read_bytes())
        return [np.array_equal(np.sort(getattr(a, k)), np.sort(getattr(b, k)))
                for k in ("chunk_hashes", "path_hashes", "content_hashes")]

    assert same(scenario) == [True] * 3


def test_reference_brotli_store_downsync_bit_exact(tmp_path):
    """The reference CLI's brotli store comes back bit-exact through the
    system libbrotli where present and through the from-spec decoder,
    in both packages."""
    def scenario(side):
        vi = side.version_index.VersionIndex.from_bytes(
            (GOLDEN / "ref_brotli.lvi").read_bytes())
        brotli = side.brotli
        trees = {}

        def run(sub):
            store = compressed_store(side, side.storage.FSStorage(),
                                     str(GOLDEN / "brotli_store"))
            target = tmp_path / side.name / sub
            downsync(side, store, side.storage.FSStorage(), str(target), vi)
            trees[sub] = files_under(target)

        if brotli.available():
            run("via_libbrotli")
        saved = brotli._enc, brotli._dec
        try:
            brotli._enc = brotli._dec = False   # force the from-spec path
            run("via_spec_decoder")
        finally:
            brotli._enc, brotli._dec = saved
        return trees

    trees = same(scenario)
    assert all(t == files_under(SAMPLE) for t in trees.values())
