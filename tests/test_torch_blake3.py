"""The port's plain BLAKE3 (torch lane math) held against the JAX
package's batched numpy hasher and its scalar oracle."""

import numpy as np
import pytest
import torch

from longtail_tpu.ops import blake3 as jblake3
from longtail_tpu_torch.ops import blake3, blake3_kernel

torch.set_num_threads(1)

CLASSES = [1024 << k for k in range(7)]      # 1 KiB .. 64 KiB


def _batch(cls: int, seed: int):
    """Rows of one size class: lengths 0, 1, 1024, 1025, the full class
    and a few random ones, zero past each length."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, min(1024, cls), min(1025, cls), cls]
    lens += rng.integers(1, cls + 1, 3).tolist()
    data = np.zeros((len(lens), cls), np.uint8)
    for i, n in enumerate(lens):
        data[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return data, np.array(lens, np.int32)


def _port(data, lens):
    words = torch.from_numpy(data.view("<u4").view(np.int32).copy())
    lo, hi = blake3.hash_chunks_words(words, torch.from_numpy(lens))
    lo = lo.numpy().view(np.uint32).astype(np.uint64)
    hi = hi.numpy().view(np.uint32).astype(np.uint64)
    return lo | (hi << np.uint64(32))


@pytest.mark.parametrize("cls", CLASSES)
def test_plain_matches_jax_batched_and_oracle(cls):
    data, lens = _batch(cls, seed=cls)
    got = _port(data, lens)
    words = data.view("<u4")
    lo, hi = jblake3.hash_chunks_words(words, lens.astype(np.uint32), xp=np)
    want = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, want)
    oracle = [jblake3.hash64(data[i, :n].tobytes())
              for i, n in enumerate(lens)]
    np.testing.assert_array_equal(got, np.array(oracle, np.uint64))


def test_wrapper_on_cpu_is_the_plain_version():
    data, lens = _batch(4096, seed=1)
    words = torch.from_numpy(data.view(np.int32).copy())
    lens_t = torch.from_numpy(lens)
    got = blake3_kernel.hash_chunks_words_device(words, lens_t)
    want = blake3.hash_chunks_words(words, lens_t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert blake3_kernel.hash_chunks_words_device.LAUNCHES == 0


def test_constants_are_the_host_modules():
    assert blake3.IV == jblake3.IV and blake3.PERM == jblake3.PERM
    assert (blake3.CHUNK_START, blake3.CHUNK_END, blake3.PARENT,
            blake3.ROOT) == (jblake3.CHUNK_START, jblake3.CHUNK_END,
                             jblake3.PARENT, jblake3.ROOT)


@pytest.mark.parametrize("row_words", [0, 100, 256 * 3, 256 * 6])
def test_leaf_count_must_be_a_power_of_two(row_words):
    with pytest.raises(ValueError):
        blake3.leaves_per_row(row_words)


def test_to_int32_keeps_the_bits():
    x = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                     dtype=torch.int64)
    got = blake3.to_int32(x).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, x.numpy().astype(np.uint32))
