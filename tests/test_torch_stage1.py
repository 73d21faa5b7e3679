"""The port's stage 1 (scan + suffix-min + walk, plain PyTorch versions)
held against the JAX package: its Pallas kernels in interpret mode, its
XLA formulation and the reference chunker's golden vectors."""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from longtail_tpu.ops import cdc  # noqa: E402
from longtail_tpu.parallel import device_match as jdm  # noqa: E402
from longtail_tpu.parallel import stage1 as jstage1  # noqa: E402
from longtail_tpu.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig as JChunkerConfig,
)
from longtail_tpu_torch.parallel import stage1  # noqa: E402
from longtail_tpu_torch.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig,
)

torch.set_num_threads(1)

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")
GOLDEN_SIZES = [  # tests/test_chunker.py GOLDEN (test/test.cpp:3421-3443)
    81590, 46796, 36543, 83172, 76749, 79550, 41484, 20326, 31652, 19995,
    103873, 38087, 38377, 23449, 47321, 86692, 28268, 65465, 33255, 65932]


def _tiny():
    """tests/test_tpu_branch.py's tiny geometry and ragged lanes."""
    plan = stage1.Stage1Plan(ChunkerConfig.from_target(1024), lanes=8,
                             part_bytes=16384)
    jplan = jstage1.Stage1Plan(JChunkerConfig.from_target(1024), lanes=8,
                               part_bytes=16384)
    B, P = plan.lanes, plan.part_bytes
    rng = np.random.default_rng(17)
    rows = rng.integers(0, 256, (B * P // 128, 128), dtype=np.uint8)
    lengths = np.array(
        [P, P - 137, P // 2, plan.cfg.min_size, 1, 700, P, P - 1],
        dtype=np.int32)
    flat = rows.reshape(-1)
    for b, ln in enumerate(lengths):
        flat[b * P + ln: (b + 1) * P] = 0
    return plan, jplan, rows, lengths


def _port_walk(flat, lengths, plan):
    out, bins = stage1.stage1(torch.from_numpy(flat),
                              torch.from_numpy(lengths),
                              stage1.hash_table("cpu"), plan)
    assert bins is None
    return stage1.unpack_walk(out.numpy(), plan)


def _repaired(flat, lengths, plan, sizes, n, amb):
    """Per-lane exact chunk sizes: ambiguous lanes go through repair_lane."""
    P = plan.part_bytes
    out = []
    for b in range(plan.lanes):
        if amb[b]:
            out.append(stage1.repair_lane(
                flat[b * P: b * P + lengths[b]], plan.cfg))
        else:
            out.append(sizes[b, : n[b]])
    return out


@pytest.mark.parametrize("target", [1024, 4096, 32768, 131072])
def test_geometry_matches_jax(target):
    cfg, jcfg = ChunkerConfig.from_target(target), \
        JChunkerConfig.from_target(target)
    assert (cfg.min_size, cfg.avg_size, cfg.max_size) == \
        (jcfg.min_size, jcfg.avg_size, jcfg.max_size)
    assert cfg.discriminator == jcfg.discriminator
    assert cfg.padded_chunk == jcfg.padded_chunk
    P = target * 1024
    plan = stage1.Stage1Plan(cfg, 2, P)
    jplan = jstage1.Stage1Plan(jcfg, 2, P)
    assert (plan.z, plan.c_pad) == (jplan.z, jplan.c_pad)
    assert stage1.segment_bytes(cfg) == jstage1.segment_bytes(jcfg)


def test_scan_summaries_match_pallas_scan_kernel():
    """min1 / min2 / cnt per segment equal the Pallas scan kernel's
    (interpret mode) on the tiny geometry."""
    import jax.numpy as jnp

    plan, jplan, rows, lengths = _tiny()
    B, P = plan.lanes, plan.part_bytes
    kernel = jstage1._make_scan_kernel(
        jplan.cfg, P, jplan.tile_bytes, jplan.z, with_words=True)(B * P)
    tlo = jnp.asarray(cdc.HASH_TABLE[:128][None, :])
    thi = jnp.asarray(cdc.HASH_TABLE[128:][None, :])
    want = jax.jit(lambda r, ln: kernel(ln, r, r, tlo, thi))(rows, lengths)
    got = stage1.scan(torch.from_numpy(rows.reshape(-1)),
                      torch.from_numpy(lengths), stage1.hash_table("cpu"),
                      plan)
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))


def test_scan_bins_match_bin_mins_and_pallas_scan():
    """The scan's bins output on the tiny 8-lane batch: equal to
    bin_mins_from_words over the batch's words (the XLA definition: each
    gram's next word is the true next word of the flat batch, 0 after its
    last), and to the Pallas scan kernel (interpret mode,
    with_anchors=True) except at each Pallas tile's last bin, whose last
    gram the Pallas kernel completes with its own tile's first word."""
    plan, jplan, rows, lengths = _tiny()
    flat = rows.reshape(-1)
    *summaries, bins = stage1.scan(
        torch.from_numpy(flat), torch.from_numpy(lengths),
        stage1.hash_table("cpu"), plan, with_bins=True)
    got = bins.numpy().view(np.uint32)
    words = flat.view("<u4")
    np.testing.assert_array_equal(
        got, np.asarray(jdm.bin_mins_from_words(jax.device_put(words),
                                                len(words))))
    for a, b in zip(summaries, stage1.scan(
            torch.from_numpy(flat), torch.from_numpy(lengths),
            stage1.hash_table("cpu"), plan)):
        assert torch.equal(a, b)
    # the composition the pipeline runs: the same bins, the same walk
    out, sbins = stage1.stage1(torch.from_numpy(flat),
                               torch.from_numpy(lengths),
                               stage1.hash_table("cpu"), plan, with_bins=True)
    assert torch.equal(sbins, bins)
    assert torch.equal(out, stage1.stage1(
        torch.from_numpy(flat), torch.from_numpy(lengths),
        stage1.hash_table("cpu"), plan)[0])
    _, pbins, _ = jstage1._make_stage1_pallas(jplan, with_anchors=True)(
        rows, lengths)
    pbins = np.asarray(pbins).reshape(-1)
    per_tile = jplan.tile_bytes // 256
    tile_last = np.zeros(len(got), bool)
    tile_last[per_tile - 1::per_tile] = True
    assert len(got) == len(pbins) and tile_last.sum() == len(got) // per_tile
    np.testing.assert_array_equal(got[~tile_last], pbins[~tile_last])


def test_stage1_matches_pallas_interpret_and_xla():
    """(sizes, n, ambiguous) per lane equal the Pallas scan+walk
    kernels' (interpret mode) exactly, flags included; after repair every
    lane equals the exact XLA formulation."""
    plan, jplan, rows, lengths = _tiny()
    flat = rows.reshape(-1)
    sizes, n, amb = _port_walk(flat, lengths, plan)

    sz_p, n_p, amb_p = jstage1.unpack_stage1(
        np.asarray(jstage1._make_stage1_pallas(jplan)(rows, lengths)[0]),
        jplan)
    np.testing.assert_array_equal(amb, amb_p)
    np.testing.assert_array_equal(n, n_p)
    np.testing.assert_array_equal(sizes, sz_p)

    sz_x, n_x, _ = jstage1.unpack_stage1(
        np.asarray(jstage1._make_stage1_xla(jplan)(rows, lengths)[0]),
        jplan)
    for b, got in enumerate(_repaired(flat, lengths, plan, sizes, n, amb)):
        np.testing.assert_array_equal(got, sz_x[b, : n_x[b]])


def test_golden_vectors():
    """chunker.input through Stage1Plan(target 131072, 1 lane, 1 MiB):
    Z = 2048, c_pad = 128, and the reference's golden chunk sizes."""
    data = np.fromfile(os.path.join(TESTDATA, "chunker.input"),
                       dtype=np.uint8)
    plan = stage1.Stage1Plan(ChunkerConfig.from_target(131072), lanes=1,
                             part_bytes=1 << 20)
    assert (plan.z, plan.c_pad) == (2048, 128)
    flat = np.zeros(plan.part_bytes, np.uint8)
    flat[: len(data)] = data
    lengths = np.array([len(data)], np.int32)
    sizes, n, amb = _port_walk(flat, lengths, plan)
    got = _repaired(flat, lengths, plan, sizes, n, amb)[0]
    assert got.tolist() == GOLDEN_SIZES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage1_matches_host_chunker(seed):
    """Structured lanes (noise, zero runs, short periods) at the default
    geometry's segment size (Z = 512) against the host chunker."""
    cfg = ChunkerConfig.from_target(32768)
    plan = stage1.Stage1Plan(cfg, lanes=3, part_bytes=1 << 18)
    B, P = plan.lanes, plan.part_bytes
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 256, B * P, dtype=np.uint8)
    flat[P // 3: P // 3 + 70000] = 0
    flat[P + 5000: P + 5000 + 90000] = np.resize(flat[:4352], 90000)
    lengths = np.array(
        [P, P - 4097 * (seed + 1), 65 * (seed + 1) + cfg.max_size], np.int32)
    for b, ln in enumerate(lengths):
        flat[b * P + ln: (b + 1) * P] = 0
    sizes, n, amb = _port_walk(flat, lengths, plan)
    for b, got in enumerate(_repaired(flat, lengths, plan, sizes, n, amb)):
        part = flat[b * P: b * P + lengths[b]]
        ends = cdc.chunk_part(part, cfg.min_size, cfg.avg_size, cfg.max_size)
        np.testing.assert_array_equal(got,
                                      np.diff(np.concatenate([[0], ends])))


def test_suffix_min_is_exclusive_per_part():
    cfg = ChunkerConfig.from_target(1024)
    plan = stage1.Stage1Plan(cfg, lanes=2, part_bytes=4096)
    Sp = plan.segments_per_part
    rng = np.random.default_rng(3)
    m1 = rng.integers(0, 10**6, 2 * Sp).astype(np.int32)
    suf = stage1.suffix_min(torch.from_numpy(m1), plan).numpy()
    for b in range(2):
        seg = m1[b * Sp:(b + 1) * Sp]
        want = [seg[s + 1:].min() if s + 1 < Sp else stage1.BIG
                for s in range(Sp)]
        np.testing.assert_array_equal(suf[b * Sp:(b + 1) * Sp], want)


def _candidate_like_the_kernel(h: np.ndarray, d: int) -> np.ndarray:
    """csrc/stage1.cu's candidate test in numpy uint64: n = (h * inv +
    inv) mod 2**32 and r = rotr(n, shift); the filter r <= lim passes
    the candidates and r = 0 alone (asserted), and a candidate is r <=
    lim with r != 0 unless inv = 1 (d a power of two)."""
    inv, lim, shift = stage1.scan_constants(d)
    m = np.uint64(0xFFFFFFFF)
    n = (h * np.uint64(inv) + np.uint64(inv)) & m
    r = ((n >> np.uint64(shift)) |
         (n << np.uint64((32 - shift) % 32))) & m
    passed = r <= np.uint64(lim)
    exact = passed & ((r != 0) | (inv == 1))
    np.testing.assert_array_equal(passed, exact | (r == 0))
    return exact


def test_scan_constants_reproduce_the_modulo():
    """The scan kernel's division-free candidate test equals h % d == d - 1
    for the discriminator of every target from 1 KiB to 512 KiB (and a few
    others: 1, powers of two, odd, the largest u32) at h = 0, d - 2, d - 1,
    d, multiples of d and their neighbours, the top of the range and 1e5
    random values."""
    ds = {ChunkerConfig.from_target(t).discriminator
          for t in range(1024, (512 << 10) + 1, 1024)}
    assert len(ds) > 400
    ds |= {1, 2, 3, 4096, 1 << 31, 12318 * 1024, 0xFFFFFFFF,
           ChunkerConfig(48, 64, 256).discriminator}
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2**32, 100_000, dtype=np.uint64)
    top = 0xFFFFFFFF
    for d in sorted(ds):
        near = [k * d + o for k in (1, 2, 3, top // d - 1, top // d)
                for o in (-1, 0, 1)]
        h = np.concatenate([np.array(
            [x for x in [0, d - 2, d - 1, d, top - 1, top] + near
             if 0 <= x <= top], np.uint64), rand])
        want = h % np.uint64(d) == np.uint64(d - 1)
        np.testing.assert_array_equal(_candidate_like_the_kernel(h, d), want,
                                      err_msg=f"d = {d}")
    with pytest.raises(ValueError):
        stage1.scan_constants(0)


def test_plan_rejects_unaligned_parts():
    with pytest.raises(ValueError):
        stage1.Stage1Plan(ChunkerConfig.from_target(1024), 1, 1000)


@pytest.mark.parametrize("part", [16384, 1 << 20])
def test_walk_scratch_only_past_the_shared_memory_cap(part):
    """The walk's global scratch exists only where a part can hold more
    than WALK_CAP states (2 per segment + 2), sized for that, and one
    geometry on one stream reuses it."""
    plan = stage1.Stage1Plan(ChunkerConfig.from_target(1024), 2, part)
    stride = 2 * plan.segments_per_part + 2
    s32, s8 = stage1.walk_scratch(plan, "cpu")
    if stride <= stage1.WALK_CAP:
        assert (s32, s8) == (None, None)
        return
    assert (s32.numel(), s8.numel()) == (4 * 2 * stride, 2 * stride)
    again = stage1.walk_scratch(plan, "cpu")
    assert again[0] is s32 and again[1] is s8


def _plan_with_c_pad(plan, c_pad):
    """plan with its c_pad cut to c_pad (the walk's truncation case)."""
    @dataclasses.dataclass(frozen=True)
    class Cut(stage1.Stage1Plan):
        @property
        def c_pad(self):
            return c_pad
    return Cut(plan.cfg, plan.lanes, plan.part_bytes)


def _walk_case(name):
    """The adversarial summaries chip_smoke.py gives the walk kernel, at
    the CPU's size: (plan, numpy-seeded batch bytes, lengths)."""
    rng = np.random.default_rng(23)
    P = 16384
    cfg = ChunkerConfig.from_target(1024)
    if name == "zeros":                       # forced cuts only
        return (stage1.Stage1Plan(cfg, 2, P), np.zeros(2 * P, np.uint8),
                [P, P - 4096])
    if name == "dense":                       # ambiguous lanes
        data = rng.integers(0, 256, 2 * P, dtype=np.uint8)
        return (stage1.Stage1Plan(ChunkerConfig(48, 64, 256), 2, P), data,
                [P, P - 777])
    data = rng.integers(0, 256, 4 * P, dtype=np.uint8)
    plan = stage1.Stage1Plan(cfg, 4, P)
    if name == "lengths":                     # 0, below min_size, ragged
        return plan, data, [0, cfg.min_size - 1, P - 4097, P]
    return _plan_with_c_pad(plan, 8), data, [P, P - 1, 3000, 100]


@pytest.mark.parametrize("name", ["zeros", "dense", "lengths", "c_pad"])
def test_walk_matches_pallas_interpret_on_adversarial_summaries(name):
    """walk_plain (the card's walk kernel's reference) against the JAX
    package's walk kernel in interpret mode, on the summaries of a part
    of zeros, of dense candidates with ambiguous lanes, of lengths 0 and
    below min_size, and with the cut list truncated at c_pad: equal cut
    ends (up to n_chunks), counts and ambiguity flags."""
    plan, data, lengths = _walk_case(name)
    lens = np.asarray(lengths, np.int32)
    P = plan.part_bytes
    for b, n in enumerate(lens):
        data[b * P + n:(b + 1) * P] = 0
    lt = torch.from_numpy(lens)
    m1, m2, cn = stage1.scan(torch.from_numpy(data), lt,
                             stage1.hash_table("cpu"), plan)
    suf = stage1.suffix_min(m1, plan)
    got = stage1.walk(lt, m1, m2, cn, plan).numpy()
    assert np.array_equal(got, stage1.walk_plain(lt, m1, m2, cn, suf,
                                                 plan).numpy())
    rows = plan.lanes * plan.segments_per_part // 128
    jcfg = JChunkerConfig(plan.cfg.min_size, plan.cfg.avg_size,
                          plan.cfg.max_size)
    ends, flags = jstage1._make_walk_kernel(
        jcfg, plan.lanes, P, plan.z, plan.c_pad)(
        lens.reshape(-1, 1), *(t.numpy().reshape(rows, 128)
                               for t in (m1, m2, cn, suf)))
    ends, flags = np.asarray(ends), np.asarray(flags)
    n = got[:, plan.c_pad]
    np.testing.assert_array_equal(n, flags[0, :plan.lanes])
    np.testing.assert_array_equal(got[:, plan.c_pad + 1],
                                  flags[1, :plan.lanes])
    for b in range(plan.lanes):
        np.testing.assert_array_equal(got[b, :n[b]], ends[:n[b], b])
        assert not got[b, n[b]:plan.c_pad].any()
    if name == "zeros":
        assert n.tolist() == [8, 6] and not got[:, -1].any()
    if name == "dense":
        assert got[:, -1].all()
    if name == "c_pad":
        assert (n == plan.c_pad).sum() >= 2
