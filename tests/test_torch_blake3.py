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
    flat = torch.from_numpy(data.reshape(-1).copy())
    starts = torch.arange(0, data.size, data.shape[1], dtype=torch.int32)
    plan = torch.from_numpy(blake3.plan_blocks(blake3.leaves_of(lens)))
    got = blake3_kernel.hash_chunks_device(flat, starts, lens_t, plan)
    for g, w in zip(got, blake3.hash_chunks_batch(flat, starts, lens_t)):
        assert torch.equal(g, w)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert blake3_kernel.hash_chunks_device.LAUNCHES == 0


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


def _adversarial_chunks(seed: int = 5):
    """A 192 KiB batch and chunks the batch kernel must get right: odd
    starts, sizes 0, 1, 63, 64, 1023, 1024, 1025, the default geometry's
    largest chunk (64 KiB), size 0 at the batch's end, and a chunk ending
    on the batch's last byte."""
    rng = np.random.default_rng(seed)
    n = 192 << 10
    batch = rng.integers(0, 256, n, dtype=np.uint8)
    sizes = [0, 1, 63, 64, 1023, 1024, 1025, 65536, 4097, 33 << 10, 0, 777]
    starts = [5, 17, 1001, 3, 4095, 40961, 77, 70001, 1, 9, n, n - 777]
    sizes += rng.integers(0, 9000, 20).tolist()
    starts += [int(rng.integers(0, n - s + 1)) for s in sizes[-20:]]
    return batch, np.array(starts, np.int32), np.array(sizes, np.int32)


def _jax_pack_hash(batch, starts, sizes):
    """The JAX package's stage 3 on the same chunks: its Pallas pack
    kernel in interpret mode per power-of-two class (size-0 rows last, as
    it requires), then its numpy hash_chunks_words."""
    jax = pytest.importorskip("jax")
    from longtail_tpu.parallel import pipeline as jpipeline

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
        lo, hi = jblake3.hash_chunks_words(words, sz.astype(np.uint32),
                                           xp=np)
        out[idx] = (lo.astype(np.uint64) |
                    (hi.astype(np.uint64) << np.uint64(32)))[:len(idx)]
    return out


def test_batch_plain_matches_jax_pack_then_hash_and_oracle():
    """hash_chunks_batch (the batch kernel's plain version) reading chunks
    from the batch equals the JAX package's Pallas pack (interpret mode)
    + hash_chunks_words, and hash64 of each chunk's bytes."""
    batch, starts, sizes = _adversarial_chunks()
    lo, hi = blake3.hash_chunks_batch(torch.from_numpy(batch),
                                      torch.from_numpy(starts),
                                      torch.from_numpy(sizes))
    got = (lo.numpy().view(np.uint32).astype(np.uint64) |
           (hi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)))
    np.testing.assert_array_equal(got, _jax_pack_hash(batch, starts, sizes))
    oracle = [jblake3.hash64(batch[s:s + n].tobytes())
              for s, n in zip(starts, sizes)]
    np.testing.assert_array_equal(got, np.array(oracle, np.uint64))
    assert starts[11] + sizes[11] == len(batch) and sizes[7] == 65536


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_covers_every_leaf_once_in_order(seed):
    """plan_blocks: every chunk in exactly one block, in order, none
    across two blocks; each block's leaves (hence every leaf once) within
    the kernel's slots and its chunks within its threads; a block starts
    where a chunk's first leaf enters a new range of BLOCK_LEAVES."""
    rng = np.random.default_rng(seed)
    T, M = blake3.BLOCK_LEAVES, blake3.MAX_LEAVES
    sizes = np.concatenate([
        rng.integers(0, 70000, 3000), np.zeros(300, np.int64),
        np.full(5, M * 1024), rng.integers(1, 2048, 500)])
    rng.shuffle(sizes)
    leaves = blake3.leaves_of(sizes)
    plan = blake3.plan_blocks(leaves)
    assert plan[0] == 0 and plan[-1] == len(sizes)
    assert (np.diff(plan) > 0).all()
    first_leaf = np.cumsum(leaves) - leaves
    covered = []
    for b in range(len(plan) - 1):
        chunks = np.arange(plan[b], plan[b + 1])
        covered.append(chunks)
        assert len(chunks) <= T
        assert leaves[chunks].sum() <= T - 1 + M
        assert (first_leaf[chunks] // T == first_leaf[chunks[0]] // T).all()
        if b:
            assert first_leaf[chunks[0]] // T > \
                first_leaf[chunks[0] - 1] // T
    np.testing.assert_array_equal(np.concatenate(covered),
                                  np.arange(len(sizes)))
    assert blake3.plan_blocks(np.zeros(0, np.int64)).tolist() == [0]
    with pytest.raises(ValueError):
        blake3.leaves_of([M * 1024 + 1])


def _kernel_schedule_hash(batch: bytes, starts, sizes, plan):
    """The batch kernel's schedule in Python, with the scalar oracle's
    compressions: per block, leaf slots at the scanned leaf offsets, then
    per level the merges of all the block's chunks numbered by a scan and
    each merging slots 2 k step and (2 k + 1) step into the first."""
    out = [None] * len(sizes)
    for b in range(len(plan) - 1):
        chunks = range(plan[b], plan[b + 1])
        n_leaves = [max(1, -(-int(sizes[c]) // 1024)) for c in chunks]
        off = np.concatenate([[0], np.cumsum(n_leaves)]).tolist()
        slots = [None] * off[-1]
        for i, c in enumerate(chunks):
            data = batch[starts[c]:starts[c] + sizes[c]]
            for j in range(n_leaves[i]):
                slots[off[i] + j] = blake3._leaf_output(
                    data[j * 1024:(j + 1) * 1024], j, n_leaves[i] == 1)
        step = 1
        while True:
            nodes = [-(-n // step) for n in n_leaves]
            merges = [n // 2 for n in nodes]
            if not sum(merges):
                break
            task = np.concatenate([[0], np.cumsum(merges)]).tolist()
            for t in range(task[-1]):
                i = int(np.searchsorted(task, t, side="right")) - 1
                k = t - task[i]
                left = off[i] + 2 * k * step
                slots[left] = blake3._parent_output(
                    slots[left][:8], slots[left + step][:8], nodes[i] == 2)
            step *= 2
        for i, c in enumerate(chunks):
            out[c] = slots[off[i]][0] | (slots[off[i]][1] << 32)
    return np.array(out, np.uint64)


def test_kernel_schedule_matches_oracle():
    """The batch kernel's leaf-slot and merge-task schedule, run in Python
    over the plan of the adversarial chunks (and over one block holding a
    1024-leaf chunk behind small ones), gives hash64 of every chunk."""
    batch, starts, sizes = _adversarial_chunks()
    big = np.random.default_rng(9).integers(0, 256, 1 << 20,
                                            dtype=np.uint8)
    cases = [(batch, starts, sizes),
             (big, np.array([0, 3, 100, 7], np.int32),
              np.array([2000, 1, (1 << 20) - 100, 0], np.int32))]
    for data, st, sz in cases:
        plan = blake3.plan_blocks(blake3.leaves_of(sz))
        got = _kernel_schedule_hash(data.tobytes(), st, sz, plan)
        want = [jblake3.hash64(data[s:s + n].tobytes())
                for s, n in zip(st, sz)]
        np.testing.assert_array_equal(got, np.array(want, np.uint64))
