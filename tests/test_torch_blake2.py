"""The port's BLAKE2s-64 (plain PyTorch version of kernel 6, the BLAKE2
device data plane and its version index) held against the JAX package's
numpy hasher, its Pallas kernel in interpret mode and hashlib; every
comparison is exact."""

import hashlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from longtail_tpu.core.indexing import (  # noqa: E402
    create_version_index as j_create_version_index,
)
from longtail_tpu.formats import constants as C  # noqa: E402
from longtail_tpu.ops import blake2 as jblake2  # noqa: E402
from longtail_tpu.ops import blake2_kernel as jblake2_kernel  # noqa: E402
from longtail_tpu.stores.storage import (  # noqa: E402
    MemStorage,
    ensure_parent_dirs,
)
from longtail_tpu_torch.core.indexing import (  # noqa: E402
    create_version_index,
)
from longtail_tpu_torch.ops import blake2, blake2_kernel  # noqa: E402
from longtail_tpu_torch.parallel import pipeline  # noqa: E402

torch.set_num_threads(1)


def _rows(seed, rows, padded, lengths=()):
    rng = np.random.default_rng(seed)
    data = np.zeros((rows, padded), np.uint8)
    lens = rng.integers(0, padded + 1, size=(rows,)).astype(np.int32)
    lens[: len(lengths)] = lengths
    for i in range(rows):
        data[i, : lens[i]] = rng.integers(0, 256, size=lens[i],
                                          dtype=np.uint8)
    return data, data.view("<u4").reshape(rows, padded // 4).copy(), lens


def _digest64(lo, hi):
    return np.asarray(lo).astype(np.uint32).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint32).astype(np.uint64) << np.uint64(32))


@pytest.mark.parametrize("padded", [64, 1024, 8192])
def test_plain_matches_jax_numpy_and_hashlib(padded):
    lengths = [x for x in (0, 1, 64, 65, 128, padded) if x <= padded]
    data, words, lens = _rows(padded, 40, padded, lengths)
    lo, hi = blake2.hash_chunks_words(torch.from_numpy(words.view(np.int32)),
                                      torch.from_numpy(lens))
    got = _digest64(lo.numpy(), hi.numpy())
    jlo, jhi = jblake2.hash_chunks_words(words, lens.astype(np.uint32))
    np.testing.assert_array_equal(got, _digest64(jlo, jhi))
    for i in range(len(lens)):
        want = int.from_bytes(hashlib.blake2s(
            data[i, : lens[i]].tobytes(), digest_size=8).digest(), "little")
        assert int(got[i]) == want, (i, lens[i])


def test_plain_matches_pallas_kernel_interpret():
    """tests/test_hashes.py's shape: 256 rows of 2 KiB, the Pallas kernel
    in interpret mode."""
    import jax.numpy as jnp

    _, words, lens = _rows(13, 256, 2048, [0, 1, 64, 65])
    jlo, jhi = jax.jit(jblake2_kernel.hash_chunks_words_device)(
        jnp.asarray(words), jnp.asarray(lens.astype(np.uint32)))
    lo, hi = blake2_kernel.hash_chunks_words_device(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(lens))
    np.testing.assert_array_equal(_digest64(lo.numpy(), hi.numpy()),
                                  _digest64(jlo, jhi))
    assert blake2_kernel.hash_chunks_words_device.LAUNCHES == 0


def test_plain_refuses_rows_off_the_block_size():
    with pytest.raises(ValueError):
        blake2.hash_chunks_words(torch.zeros((2, 12), dtype=torch.int32),
                                 torch.zeros(2, dtype=torch.int32))


TARGET = 1024
SPEC = [("big.bin", TARGET * 1024 * 2 + 777),
        ("exact_part.bin", TARGET * 1024), ("small.txt", 300), ("tiny", 1), ("empty", 0),
        ("sub/dir/nested.dat", TARGET * 512 + 5)]


def _tree():
    rng = np.random.default_rng(29)
    st = MemStorage()
    st.create_dir("src")
    for path, size in SPEC:
        ensure_parent_dirs(st, f"src/{path}")
        st.write(f"src/{path}",
                 rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
    return st


def test_blake2_version_index_bit_identical_to_jax():
    """create_version_index(device="cpu", BLAKE2) == the JAX package's with
    xp=np and with xp=jnp, byte for byte: large files hash on the device
    path, small ones with the host BLAKE2 hasher."""
    import jax.numpy as jnp

    st = _tree()
    got = create_version_index(st, "src", hash_identifier=C.HASH_TYPE_BLAKE2,
                               target_chunk_size=TARGET, device="cpu")
    for xp in (np, jnp):
        want = j_create_version_index(
            st, "src", hash_identifier=C.HASH_TYPE_BLAKE2,
            target_chunk_size=TARGET, xp=xp)
        assert got.to_bytes() == want.to_bytes()
    assert got.hash_identifier == C.HASH_TYPE_BLAKE2


def test_device_hash_kinds():
    """meow on a device is not ported yet; an unknown kind is refused."""
    st = _tree()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        create_version_index(st, "src", hash_identifier=C.HASH_TYPE_MEOW,
                             target_chunk_size=TARGET, device="cpu")
    with pytest.raises(ValueError):
        pipeline.DevicePartIndexer(TARGET, "cpu", hash_kind="meow")
