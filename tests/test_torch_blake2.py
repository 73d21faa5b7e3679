"""The port's BLAKE2s-64 (plain PyTorch versions of kernel 6, its chunk
order, the BLAKE2 device data plane and its version index) held against
the JAX package's numpy hasher, its Pallas pack and hash kernels in
interpret mode and hashlib; every comparison is exact."""

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
from longtail_tpu.parallel import pipeline as jpipeline  # noqa: E402
from longtail_tpu.stores.storage import (  # noqa: E402
    MemStorage,
    ensure_parent_dirs,
)
from longtail_tpu_torch.core.indexing import (  # noqa: E402
    create_version_index,
)
from longtail_tpu_torch.ops import blake2, blake2_kernel  # noqa: E402
from longtail_tpu_torch.ops import cdc  # noqa: E402
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
    assert blake2_kernel.hash_chunks_device.LAUNCHES == 0


def test_plain_refuses_rows_off_the_block_size():
    with pytest.raises(ValueError):
        blake2.hash_chunks_words(torch.zeros((2, 12), dtype=torch.int32),
                                 torch.zeros(2, dtype=torch.int32))


def _blake2_64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2s(data, digest_size=8).digest(),
                          "little")


def _adversarial_chunks(seed: int = 17):
    """A 192 KiB batch and chunks the batch kernel must get right: odd
    starts, sizes 0, 1, 63, 64, 65, 4 KiB - 1 and the default geometry's
    largest chunk (64 KiB), size 0 at the batch's end, and a chunk ending
    on the batch's last byte."""
    rng = np.random.default_rng(seed)
    n = 192 << 10
    batch = rng.integers(0, 256, n, dtype=np.uint8)
    sizes = [0, 1, 63, 64, 65, 4095, 65536, 0, 777, 128, 4097]
    starts = [5, 17, 1001, 3, 4093, 40961, 70001, n, n - 777, 64, 1]
    sizes += rng.integers(0, 9000, 20).tolist()
    starts += [int(rng.integers(0, n - s + 1)) for s in sizes[-20:]]
    return batch, np.array(starts, np.int32), np.array(sizes, np.int32)


def _jax_pack_hash(batch, starts, sizes):
    """The JAX package's BLAKE2 stage 3 on the same chunks: its Pallas pack
    kernel in interpret mode per power-of-two class of 1 KiB (size-0 rows
    last, as it requires), then its numpy hash_chunks_words."""
    leaves = np.maximum(-(-sizes.astype(np.int64) // 1024), 1)
    cls = 1 << np.ceil(np.log2(leaves)).astype(np.int64)
    out = np.zeros(len(sizes), np.uint64)
    for c in np.unique(cls):
        padded = int(c) * 1024
        idx = np.flatnonzero(cls == c)
        idx = np.concatenate([idx[sizes[idx] > 0], idx[sizes[idx] == 0]])
        rows = -(-len(idx) // 8) * 8
        st = np.zeros(rows, np.int32)
        sz = np.zeros(rows, np.int32)
        st[:len(idx)], sz[:len(idx)] = starts[idx], sizes[idx]
        words2d = jpipeline.make_pad_words_fn(padded // 4 + 2048)(
            jax.device_put(batch.reshape(-1, 128)))
        words = np.asarray(jpipeline.make_pack_fn(padded, rows)(
            words2d, jax.device_put(st), jax.device_put(sz)))
        lo, hi = jblake2.hash_chunks_words(words, sz.astype(np.uint32),
                                           xp=np)
        out[idx] = _digest64(lo, hi)[:len(idx)]
    return out


def test_batch_plain_matches_jax_pack_then_hash_and_hashlib():
    """hash_chunks_batch (the batch kernel's plain version) reading chunks
    from the batch equals the JAX package's Pallas pack (interpret mode) +
    hash_chunks_words, and hashlib's BLAKE2s-64 of each chunk's bytes;
    the wrapper on CPU tensors is the plain version and launches
    nothing."""
    batch, starts, sizes = _adversarial_chunks()
    args = [torch.from_numpy(x) for x in (batch, starts, sizes)]
    lo, hi = blake2.hash_chunks_batch(*args)
    got = _digest64(lo.numpy(), hi.numpy())
    np.testing.assert_array_equal(got, _jax_pack_hash(batch, starts, sizes))
    oracle = [_blake2_64(batch[s:s + n].tobytes())
              for s, n in zip(starts, sizes)]
    np.testing.assert_array_equal(got, np.array(oracle, np.uint64))
    assert starts[8] + sizes[8] == len(batch) and starts[7] == len(batch)
    order = torch.from_numpy(blake2.plan_order(sizes))
    for g, w in zip(blake2_kernel.hash_chunks_device(*args, order), (lo, hi)):
        assert torch.equal(g, w)
    assert blake2_kernel.hash_chunks_device.LAUNCHES == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_order_is_a_descending_permutation(seed):
    """plan_order: every chunk exactly once, block counts (max(1,
    ceil(size / 64))) never rising along the order, ties in chunk
    order."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([rng.integers(0, 65537, 3000),
                            np.zeros(50, np.int64), np.full(7, 65536),
                            rng.integers(1, 200, 300)])
    rng.shuffle(sizes)
    order = blake2.plan_order(sizes)
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(len(sizes)))
    blocks = np.maximum(-(-sizes // 64), 1)[order]
    assert (np.diff(blocks) <= 0).all()
    tie = np.diff(blocks) == 0
    assert (np.diff(order)[tie] > 0).all()
    assert blocks[0] == 1024 and blocks[-1] == 1


def test_device_indexer_blake2_digests_in_chunk_order():
    """DevicePartIndexer(hash_kind="blake2") on the CPU: per part, the host
    chunker's sizes and hashlib's digest of each chunk, in chunk order,
    over 3 batches of 2 lanes (ragged and short parts)."""
    rng = np.random.default_rng(31)
    ix = pipeline.DevicePartIndexer(TARGET, "cpu", lanes=2,
                                    hash_kind="blake2")
    cfg, P = ix.cfg, ix.part_bytes
    parts = [(i, rng.integers(0, 256, size=n, dtype=np.uint8))
             for i, n in enumerate([P, P // 2 + 13, 1, 700, P - 1,
                                    cfg.min_size])]
    got = list(ix.index_stream(iter(parts)))
    assert [t for t, _, _ in got] == [t for t, _ in parts]
    for (_, sizes, hashes), (_, data) in zip(got, parts):
        ends = cdc.chunk_part(data, cfg.min_size, cfg.avg_size, cfg.max_size)
        np.testing.assert_array_equal(
            sizes, np.diff(np.concatenate([[0], ends])))
        want = [_blake2_64(data[e - s:e].tobytes())
                for s, e in zip(sizes.astype(np.int64), ends)]
        np.testing.assert_array_equal(hashes, np.array(want, np.uint64))


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
    """meow with a device chunks and hashes on the host path, as the JAX
    package's xp=jnp does (its meow hasher ignores xp): the index equals
    the host path's and the JAX package's; the device indexer refuses
    meow and unknown kinds."""
    import jax.numpy as jnp

    st = _tree()
    got = create_version_index(st, "src", hash_identifier=C.HASH_TYPE_MEOW,
                               target_chunk_size=TARGET, device="cpu")
    assert got.to_bytes() == create_version_index(
        st, "src", hash_identifier=C.HASH_TYPE_MEOW,
        target_chunk_size=TARGET, device=None).to_bytes()
    assert got.to_bytes() == j_create_version_index(
        st, "src", hash_identifier=C.HASH_TYPE_MEOW,
        target_chunk_size=TARGET, xp=jnp).to_bytes()
    for kind in ("meow", "sha1"):
        with pytest.raises(ValueError):
            pipeline.DevicePartIndexer(TARGET, "cpu", hash_kind=kind)
