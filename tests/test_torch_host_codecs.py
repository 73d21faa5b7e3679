"""The port's own host hashers, codecs and native helpers held against the
JAX package's: equal 64-bit hashes over seeded buffers, equal compressed
bytes for every registered codec tag, equal outputs of the native C
helpers (built into ``build/longtail_tpu_torch/native/``), and the golden
reference stores downsynced through the port's ``api``.  The port's
Brotli decoder keeps out two faults of the JAX package's: it stops once
the output would pass ``raw_size``, and a corrupt stream raises only
``BrotliError``."""

import os
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

from longtail_tpu.ops import blake3 as jblake3  # noqa: E402
from longtail_tpu.ops import brotli_decode as jbrotli_decode  # noqa: E402
from longtail_tpu.ops import cdc as jcdc  # noqa: E402
from longtail_tpu.ops import compression_registry as jregistry  # noqa: E402
from longtail_tpu.ops import hash_registry as jhash_registry  # noqa: E402
from longtail_tpu.ops import lz4 as jlz4  # noqa: E402
from longtail_tpu.ops import zstd_device as jzstd_device  # noqa: E402
from longtail_tpu.ops import zstd_frame as jzstd_frame  # noqa: E402
from longtail_tpu_torch import api, native  # noqa: E402
from longtail_tpu_torch.formats import constants as C  # noqa: E402
from longtail_tpu_torch.formats.store_index import StoredBlock  # noqa: E402
from longtail_tpu_torch.formats.version_index import (  # noqa: E402
    VersionIndex,
)
from longtail_tpu_torch.ops import blake3, brotli, brotli_decode  # noqa: E402
from longtail_tpu_torch.ops import cdc, lz4, zstd_device  # noqa: E402
from longtail_tpu_torch.ops import compression_registry  # noqa: E402
from longtail_tpu_torch.ops import hash_registry, zstd_frame  # noqa: E402
from longtail_tpu_torch.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore,
)
from longtail_tpu_torch.stores.fsblockstore import FSBlockStore  # noqa: E402
from longtail_tpu_torch.stores.storage import FSStorage  # noqa: E402

HERE = pathlib.Path(__file__).parent
GOLDEN = HERE / "testdata" / "ref_golden"
SAMPLE = HERE / "testdata" / "sample_folder"

HASHES = {"blake3": C.HASH_TYPE_BLAKE3, "blake2": C.HASH_TYPE_BLAKE2,
          "meow": C.HASH_TYPE_MEOW}
SIZES = [0, 1, 31, 63, 64, 65, 1023, 1024, 1025, 3000]


def _data(kind, n=48 << 10, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "zeros":
        return bytes(n)
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 9, 64)]
    out = bytearray()
    while len(out) < n:
        out += words[int(rng.integers(0, 64))] + b" "
    return bytes(out[:n])


def _tree(root: pathlib.Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        out[rel + "/" if p.is_dir() else rel] = \
            None if p.is_dir() else p.read_bytes()
    return out


@pytest.mark.parametrize("name", sorted(HASHES))
def test_hasher_hash_buffer_equals_the_jax_packages(name):
    got = hash_registry.get_hasher(HASHES[name])
    want = jhash_registry.get_hasher(HASHES[name])
    assert got.identifier == want.identifier
    rng = np.random.default_rng(1)
    for n in SIZES:
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert got.hash_buffer(buf) == want.hash_buffer(buf), n


@pytest.mark.parametrize("name", sorted(HASHES))
def test_hasher_hash_chunks_equals_the_jax_packages(name):
    rng = np.random.default_rng(2)
    lengths = np.array(SIZES, dtype=np.int64)
    batch = np.zeros((len(lengths), 4096), np.uint8)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    got = hash_registry.get_hasher(HASHES[name]).hash_chunks(batch, lengths)
    want = jhash_registry.get_hasher(HASHES[name]).hash_chunks(batch,
                                                              lengths)
    np.testing.assert_array_equal(np.asarray(got, np.uint64),
                                  np.asarray(want, np.uint64))


@pytest.mark.parametrize("tag", sorted(compression_registry.supported_tags()))
@pytest.mark.parametrize("kind", ["text", "random", "zeros"])
def test_codec_bytes_equal_the_jax_packages(tag, kind):
    """Every registered tag compresses to the JAX package's bytes with the
    host codecs, and decodes back."""
    if tag in compression_registry.BrotliCodec.tags and \
            not brotli.available():
        pytest.skip("no system libbrotli to encode with")
    src = _data(kind)
    codec = compression_registry.get_codec(tag)
    assert codec.device is None
    got = codec.compress(tag, src)
    assert got == jregistry.get_codec(tag).compress(tag, src)
    assert codec.decompress(tag, got, len(src)) == src


@pytest.mark.parametrize("level", [1, 3, 9])
@pytest.mark.parametrize("kind", ["text", "random"])
def test_from_spec_zstd_frame_equals_the_jax_packages(level, kind):
    src = _data(kind, 20 << 10)
    got = zstd_frame.compress(src, level)
    assert got == jzstd_frame.compress(src, level)
    assert zstd_frame.decompress(got, len(src)) == src


def _anchored(seed=5):
    """A buffer of one 4 KiB random pattern repeated 4 times, and the
    anchors (position, reference) of its repeats."""
    pat = np.random.default_rng(seed).integers(0, 256, 4096, np.uint8)
    src = np.tile(pat, 4).tobytes() + b"tail-literals"
    apos = np.array([4096, 8192, 12288], np.int64)
    aref = np.array([0, 4096, 8192], np.int64)
    return src, apos, aref


def _native_case(name):
    """(the port's output, the JAX package's) of one native helper."""
    src, apos, aref = _anchored()
    data = np.frombuffer(_data("text", 64 << 10), np.uint8)
    if name == "cdc_scan":
        return (cdc.chunk_part(data, 128, 512, 2048),
                jcdc.chunk_part(data, 128, 512, 2048))
    if name == "blake3_hash":
        # the JAX package's scalar hash of each range is the oracle: it
        # needs no native library, whose in-place build another test
        # process may be writing (its batch call then returns None)
        off = np.array([0, 100, 5000, 9000], np.int64)
        size = np.array([0, 4000, 3001, 50000], np.int64)
        want = np.array([jblake3.hash64(data[o:o + n].tobytes())
                         for o, n in zip(off, size)], np.uint64)
        jbatch = jblake3.hash64_ranges(data, off, size)
        if jbatch is not None:
            np.testing.assert_array_equal(np.asarray(jbatch), want)
        return blake3.hash64_ranges(data, off, size), want
    if name == "lz4_block":
        return lz4.compress(data.tobytes()), jlz4.compress(data.tobytes())
    if name == "lz4_assemble":
        args = (src, [4096], [0], [12288])
        return lz4.assemble_matches(*args), jlz4.assemble_matches(*args)
    if name == "lz4_anchors":
        return (lz4.assemble_anchors(src, apos, aref),
                jlz4.assemble_anchors(src, apos, aref))
    return (zstd_device.sequences_from_anchors(src, apos, aref),
            jzstd_device.sequences_from_anchors(src, apos, aref))


NATIVE = ["blake3_hash", "cdc_scan", "lz4_anchors", "lz4_assemble",
          "lz4_block", "zstd_seq"]


@pytest.mark.parametrize("name", NATIVE)
def test_native_helper_equals_the_jax_packages(name):
    """Each native library, built from the port's own copy of its C source
    into the build directory, never beside the source, gives the JAX
    package's output."""
    got, want = _native_case(name)
    lib = native._LIBS.get(name)
    if got is None:                     # no C compiler on this host
        assert lib is None
    elif isinstance(got, bytes):
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if lib is not None:                 # None: no C compiler on this host
        assert os.path.dirname(lib._name) == native.BUILD_DIR
    src_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_native_sources_are_the_jax_packages():
    jdir = HERE.parent / "longtail_tpu" / "native"
    for name in NATIVE:
        mine = pathlib.Path(native.__file__).parent / f"{name}.c"
        assert mine.read_bytes() == (jdir / f"{name}.c").read_bytes()


@pytest.mark.parametrize("store,lvi", [("refstore", "ref.lvi"),
                                       ("brotli_store", "ref_brotli.lvi")])
def test_golden_store_downsyncs_through_the_ports_api(tmp_path, store, lvi):
    """The reference's own stores (zstd, brotli) reconstruct the sample
    folder through the port's downsync, through libbrotli where present
    and through the port's from-spec Brotli decoder."""
    vi = VersionIndex.from_bytes((GOLDEN / lvi).read_bytes())

    def run(sub):
        bs = CompressBlockStore(FSBlockStore(FSStorage(),
                                             str(GOLDEN / store)))
        api.downsync(bs, FSStorage(), str(tmp_path / sub), vi)
        assert _tree(tmp_path / sub) == _tree(SAMPLE)

    if brotli.available():
        run("system")
    saved = brotli._enc, brotli._dec
    try:
        brotli._enc = brotli._dec = False
        run("from_spec")
    finally:
        brotli._enc, brotli._dec = saved


def _brotli_blocks():
    """(payload, raw size) of every block of the reference's brotli store."""
    out = []
    for f in sorted((GOLDEN / "brotli_store" / "chunks").rglob("*.lrb")):
        sb = StoredBlock.from_bytes(f.read_bytes())
        raw, comp = np.frombuffer(sb.block_data[:8], "<u4")
        out.append((sb.block_data[8:8 + int(comp)], int(raw)))
    return out


def test_brotli_decoder_equals_the_jax_packages_and_stops_at_raw_size():
    blocks = _brotli_blocks()
    assert blocks
    for payload, raw in blocks:
        got = brotli_decode.decompress(payload, raw)
        assert got == jbrotli_decode.decompress(payload, raw)
        assert len(got) == raw
        if raw > 1:
            with pytest.raises(brotli_decode.BrotliError):
                brotli_decode.decompress(payload, raw // 2)


def test_corrupt_brotli_raises_only_brotli_error():
    """Seeded byte flips and truncations of the golden blocks: the port's
    decoder either decodes or raises BrotliError, never another type."""
    rng = np.random.default_rng(9)
    raised = 0
    for payload, raw in _brotli_blocks():
        for _ in range(12):
            b = bytearray(payload)
            if rng.integers(0, 2):
                b = b[:int(rng.integers(0, len(b)))]
            else:
                for i in rng.integers(0, len(b), 3):
                    b[int(i)] ^= int(rng.integers(1, 256))
            try:
                brotli_decode.decompress(bytes(b), raw)
            except brotli_decode.BrotliError:
                raised += 1
    assert raised > 0
