"""The port's own copies of the index formats (``longtail_tpu_torch.formats``)
held against the JAX package's: the reference's golden ``.lvi``, ``.la``,
``.lsi`` and ``.lrb`` bytes parse and re-serialise to the same bytes in
both, and truncated blobs are rejected with the port's ``FormatError``."""

import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

from longtail_tpu.formats import archive_index as jarchive  # noqa: E402
from longtail_tpu.formats import constants as jconstants  # noqa: E402
from longtail_tpu.formats import store_index as jstore  # noqa: E402
from longtail_tpu.formats import version_index as jversion  # noqa: E402
from longtail_tpu_torch.formats import archive_index  # noqa: E402
from longtail_tpu_torch.formats import constants  # noqa: E402
from longtail_tpu_torch.formats import store_index  # noqa: E402
from longtail_tpu_torch.formats import version_index  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "testdata" / "ref_golden"

# (fixture, the port's class, the JAX package's class)
BLOBS = [
    ("ref.lvi", version_index.VersionIndex, jversion.VersionIndex),
    ("ref_brotli.lvi", version_index.VersionIndex, jversion.VersionIndex),
    ("ref.la", archive_index.ArchiveIndex, jarchive.ArchiveIndex),
    ("refstore/store.lsi", store_index.StoreIndex, jstore.StoreIndex),
    ("brotli_store/store.lsi", store_index.StoreIndex, jstore.StoreIndex),
]


def _blob(name):
    return (GOLDEN / name).read_bytes()


@pytest.mark.parametrize("name,cls,jcls", BLOBS,
                         ids=[b[0] for b in BLOBS])
def test_golden_index_reserialises_like_the_jax_package(name, cls, jcls):
    data = _blob(name)
    got = cls.from_bytes(data).to_bytes()
    assert got == jcls.from_bytes(data).to_bytes()
    if not name.endswith(".la"):       # an archive carries its blocks after
        assert got == data


@pytest.mark.parametrize("store", ["refstore", "brotli_store"])
def test_golden_blocks_reserialise_like_the_jax_package(store):
    files = sorted((GOLDEN / store / "chunks").rglob("*.lrb"))
    assert files
    for f in files:
        data = f.read_bytes()
        got = store_index.StoredBlock.from_bytes(data)
        want = jstore.StoredBlock.from_bytes(data)
        assert got.to_bytes() == want.to_bytes() == data
        assert got.block_index.to_bytes() == want.block_index.to_bytes()
        assert got.block_index.tag == want.block_index.tag


@pytest.mark.parametrize("name,cls,jcls", BLOBS,
                         ids=[b[0] for b in BLOBS])
def test_truncated_blob_is_rejected_with_the_ports_format_error(
        name, cls, jcls):
    """Every cut the JAX package rejects with FormatError, the port rejects
    with its own FormatError (a ValueError that is not the JAX package's);
    a cut the JAX package reads, the port reads to the same bytes."""
    data = _blob(name)
    cuts = sorted({0, 1, 4, 8, 16, 23, 24, 31, len(data) // 3,
                   len(data) // 2, len(data) - 9})
    rejected = 0
    for n in cuts:
        try:
            want = jcls.from_bytes(data[:n]).to_bytes()
        except jversion.FormatError:
            with pytest.raises(version_index.FormatError) as got:
                cls.from_bytes(data[:n])
            assert not isinstance(got.value, jversion.FormatError)
            rejected += 1
        else:
            assert cls.from_bytes(data[:n]).to_bytes() == want, n
    assert rejected >= 2


def test_constants_equal_the_jax_packages():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names
    for n in names:
        assert getattr(constants, n) == getattr(jconstants, n), n
    for target in (512, 4096, 32768):
        assert constants.chunker_params_from_target(target) == \
            jconstants.chunker_params_from_target(target)


def test_built_store_index_bytes_equal_the_jax_packages():
    """A store index built from seeded block indexes in both packages."""
    rng = np.random.default_rng(3)
    blocks, jblocks = [], []
    for b in range(3):
        n = 4 + b
        kw = dict(block_hash=int(rng.integers(1, 2**63)),
                  hash_identifier=constants.HASH_TYPE_BLAKE3,
                  tag=constants.COMPRESSION_TYPE_ZSTD_DEFAULT,
                  chunk_hashes=rng.integers(0, 2**63, n, dtype=np.uint64),
                  chunk_sizes=rng.integers(1, 2**16, n).astype(np.uint32))
        blocks.append(store_index.BlockIndex(**kw))
        jblocks.append(jstore.BlockIndex(**kw))
    got = store_index.StoreIndex.from_blocks(blocks).to_bytes()
    assert got == jstore.StoreIndex.from_blocks(jblocks).to_bytes()
    assert store_index.StoreIndex.from_bytes(got).to_bytes() == got
