"""The port's block codecs of ``upsync --device`` on the CPU path (anchor
matching, the Huffman literal pack, zstd frames, the LZ4 and zstd device
codecs, the codec registry and the compression store) held against the
JAX package, byte for byte; every comparison is exact (integers and
bytes, tolerance 0)."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from longtail_tpu import api as japi  # noqa: E402
from longtail_tpu.formats import constants as C  # noqa: E402
from longtail_tpu.ops import device_entropy as jentropy  # noqa: E402
from longtail_tpu.ops import entropy_kernel as jek  # noqa: E402
from longtail_tpu.ops import lz4, zstd, zstd_frame  # noqa: E402
from longtail_tpu.ops import zstd_device as jzstd_device  # noqa: E402
from longtail_tpu.ops import compression_registry as jregistry  # noqa: E402
from longtail_tpu.ops.compression_registry import (  # noqa: E402
    Lz4Codec as JLz4Codec,
    ZstdCodec as JZstdCodec,
)
from longtail_tpu.parallel import device_lz4 as jdevice_lz4  # noqa: E402
from longtail_tpu.parallel import device_match as jdm  # noqa: E402
from longtail_tpu.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore as JCompressBlockStore,
)
from longtail_tpu.stores.fsblockstore import FSBlockStore  # noqa: E402
from longtail_tpu.stores.storage import FSStorage  # noqa: E402
from longtail_tpu_torch import _kernels, api, cli  # noqa: E402
from longtail_tpu_torch.ops import (  # noqa: E402
    compression_registry,
    device_entropy,
    entropy_kernel,
    zstd_device,
)
from longtail_tpu_torch.parallel import device_lz4  # noqa: E402
from longtail_tpu_torch.parallel import device_match as dm  # noqa: E402
from longtail_tpu_torch.stores.compressblockstore import (  # noqa: E402
    CompressBlockStore,
)

torch.set_num_threads(1)


def structured(seed: int, n: int) -> bytes:
    """Text-like repeats, zeros, tile repeats and noise."""
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog; pack box. "
            * 400)
    tile = rng.integers(0, 256, 6 << 10, np.uint8).tobytes() * 5
    noise = rng.integers(0, 256, 20000, np.uint8).tobytes()
    unit = text + bytes(9000) + tile + noise
    return (unit * (n // len(unit) + 1))[:n]


def _words(src: bytes) -> np.ndarray:
    return np.frombuffer(src, "<u4").copy()


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32))


# ---------------------------------------------------------------------------
# anchors (parallel/device_match.py)
# ---------------------------------------------------------------------------

def test_anchor_rows_match_jax():
    """make_anchor_fn: packed rows and counts over 3 rows plus ignored
    trailing words."""
    w = _words(structured(1, 3 * dm.ROW_WORDS * 4 + 4000))
    packed, counts = dm.anchor_rows(_t(w))
    jp, jc = jdm.make_anchor_fn(len(w))(jax.device_put(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.min() > 0


def test_bin_mins_match_jax():
    w = _words(structured(2, 1 << 18))
    got = dm.bin_mins_from_words(_t(w), len(w) - 64)
    want = jdm.bin_mins_from_words(jax.device_put(w), len(w) - 64)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("suppress,window", [
    (True, "lz4"), (False, "lz4"), (True, "block"), (False, "block")])
def test_fast_anchors_match_jax(suppress, window):
    """make_fast_anchor_fn over 3 blocks, the last one ragged (zero-padded),
    with the LZ4 window and with the whole-block window."""
    block_words = 1 << 15
    w = _words(structured(3, 2 * block_words * 4 + 40000))
    max_off = 16383 if window == "lz4" else block_words
    got = dm.fast_anchors(_t(w), block_words, max_offset_words=max_off,
                          suppress_sampled_chains=suppress)
    want = jdm.make_fast_anchor_fn(len(w), block_words,
                                   max_offset_words=max_off,
                                   suppress_sampled_chains=suppress)(
        jax.device_put(w))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert got[2].min() > 0
    got_lists = dm.fast_block_anchors(_t(w), block_words,
                                      max_offset_words=max_off,
                                      suppress_sampled_chains=suppress)
    want_lists = jdm.fast_block_anchors(jax.device_put(w), block_words,
                                        max_offset_words=max_off,
                                        suppress_sampled_chains=suppress)
    for (gp, gr), (wp, wr) in zip(got_lists, want_lists, strict=True):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gr, wr)


def test_bins_and_fast_anchors_packed_match_jax():
    """make_bins_anchor_packed_fn with a ragged tail block (sentinel
    padding) and make_fast_anchor_packed_fn on the same words."""
    w = _words(structured(4, 5 << 16))
    n_bins = len(w) // dm.BIN_WORDS
    bins = dm.bin_mins_from_words(_t(w), len(w))
    got = dm.bins_anchors_packed(bins, 512)
    want = jdm.make_bins_anchor_packed_fn(n_bins, 512)(
        jax.device_put(bins.numpy().view(np.uint32)))
    assert got.shape[0] == -(-n_bins // 512) == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = dm.fast_anchors_packed(_t(w), 512 * dm.BIN_WORDS)
    want = jdm.make_fast_anchor_packed_fn(len(w), 512 * dm.BIN_WORDS)(
        jax.device_put(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [
    4 * dm.ROW_WORDS * 4,               # whole rows
    3 * dm.ROW_WORDS * 4 + 4000,        # a last row cut short
    5 * dm.ROW_WORDS * 4 + 100])        # 6 rows, not a power of two
def test_block_anchors_match_jax(n):
    """device_lz4.block_anchors pads to whole rows; the JAX package pads to
    a power-of-two row count: the anchors below n are the same."""
    src = structured(5, n)
    pos, ref = device_lz4.block_anchors(src, "cpu")
    jpos, jref = jdevice_lz4.block_anchors(src)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(ref, jref)
    assert len(pos) > 0 and pos.max() < n
    assert pos.dtype == ref.dtype == np.int64


# ---------------------------------------------------------------------------
# the Huffman literal pack (ops/entropy_kernel.py, kernel 5's plain version)
# ---------------------------------------------------------------------------

def _lits(seed, s, n_pad, skewed=False):
    rng = np.random.default_rng(seed)
    p = np.r_[[0.75], np.full(255, 0.25 / 255)] if skewed else \
        np.r_[np.full(8, 0.09), np.full(248, 0.28 / 248)]
    return rng.choice(np.arange(256), size=(s, n_pad), p=p).astype(np.uint8)


def _codes(lits):
    built = zstd_frame.build_huffman(
        np.bincount(lits.reshape(-1), minlength=256).tolist())
    _, code_val, code_len = built
    cv = np.zeros(256, np.int32)
    cl = np.zeros(256, np.int32)
    cv[: len(code_val)] = code_val
    cl[: len(code_len)] = code_len
    return cv, cl


def _check_hufpack(lits, n_lit):
    S, n_pad = lits.shape
    cv, cl = _codes(lits)
    table = torch.from_numpy(entropy_kernel.pack_code_table(cv, cl))
    words, totals = entropy_kernel.hufpack(
        torch.from_numpy(lits), torch.from_numpy(n_lit), table)
    words = words.numpy().view(np.uint32)
    totals = totals.numpy()
    wx, tx = jentropy._make_hufpack_xla(n_pad, 6, S)(lits, n_lit, cv, cl)
    np.testing.assert_array_equal(words, np.asarray(wx))
    np.testing.assert_array_equal(totals, np.asarray(tx))
    # the Pallas kernel misaddresses rows whose 128-byte row count its row
    # tile does not divide, and its guard lets them through (ROADMAP
    # queue C): it is held only where its tiling holds
    if n_pad % 128 == 0 and n_pad >= jek.MIN_PALLAS_PAD and \
            (n_pad // 128) % jek._row_tile(n_pad) == 0:
        wp, tp = jek.make_hufpack_rows_fn(n_pad, S)(
            lits.reshape(-1, 128), n_lit, jek.pack_code_table(cv, cl))
        np.testing.assert_array_equal(totals, np.asarray(tp))
        np.testing.assert_array_equal(
            words, np.asarray(wp)[:, :words.shape[1]])
    # the host encoder's stream (before its sentinel bit) bit for bit
    for s in range(S):
        t = int(totals[s])
        host = zstd_frame._huf_encode_stream(
            lits[s, :n_lit[s]].tobytes(), cv.tolist(), cl.tolist())
        w = words[s].copy()
        w[t >> 5] |= np.uint32(1 << (t & 31))
        assert w.tobytes()[: (t + 8) // 8] == host


@pytest.mark.parametrize("s,n_pad,fill", [
    (1, 256, 256), (2, 256, 200), (4, 512, 300), (1, 1024, 1024),
    (2, 2048, 1500), (4, 4096, 4096),
])
def test_hufpack_plain_matches_xla_and_pallas(s, n_pad, fill):
    """S streams, the last one ragged, against the XLA scatter oracle,
    the Pallas kernel in interpret mode (n_pad >= its minimum) and the
    host encoder."""
    lits = _lits(fill, s, n_pad)
    n_lit = np.full((s,), fill, np.int32)
    n_lit[-1] = max(1, fill - 129)
    for i in range(s):
        lits[i, n_lit[i]:] = 0
    _check_hufpack(lits, n_lit)


def test_hufpack_skewed_code_lengths():
    """1-bit codes (most contributions per word) and 11-bit codes (the
    most spill) in the same streams."""
    lits = _lits(9, 2, 2048, skewed=True)
    cv, cl = _codes(lits)
    assert cl.max() == zstd_frame.MAX_HUF_BITS and cl[cl > 0].min() == 1
    _check_hufpack(lits, np.array([2048, 2047], np.int32))


@pytest.mark.parametrize("n_pad,n_lit", [
    (65536, [65536, 65536 - 8191]), (2 * 32768 + 4096, [69632, 33000, 5]),
    (32768 + 16, [32784, 0, 32771]),
])
def test_hufpack_rows_longer_than_a_kernel_stream(n_pad, n_lit, monkeypatch):
    """Rows longer than the longest stream a block of the frame kernel
    takes (MAX_STREAM_LITS; bench.py's device_entropy packs rows of 128
    KiB through make_hufpack_rows_fn) go to the rows kernel's plain
    version as one piece list of MAX_STREAM_LITS-literal pieces, never
    through the frame pack, and the packed rows equal the JAX package's XLA scatter
    oracle, its Pallas kernel in interpret mode (where its tiling holds:
    65536) and the host encoder, with 1-bit and 11-bit codes."""
    calls = []
    row_pieces = entropy_kernel.row_pieces

    def spy(n_lit, n_pad):
        calls.append(row_pieces(n_lit, n_pad).numpy().copy())
        return torch.from_numpy(calls[-1])

    def no_frame(*args):
        raise AssertionError("the rows went through the frame pack")

    monkeypatch.setattr(entropy_kernel, "row_pieces", spy)
    monkeypatch.setattr(entropy_kernel, "hufpack_frame", no_frame)
    n_lit = np.array(n_lit, np.int32)
    # byte 0 most of the time, 20 bytes 100 times and the rest once a
    # tile: 1-bit and 11-bit codes
    rng = np.random.default_rng(11)
    tile = np.repeat(np.arange(256), np.r_[[12000], np.full(20, 100),
                                           np.ones(235, np.int64)])
    lits = np.stack([np.resize(rng.permutation(tile), n_pad)
                     for _ in n_lit]).astype(np.uint8)
    for i, n in enumerate(n_lit):
        lits[i, n:] = 0
    cv, cl = _codes(lits)
    assert cl.max() == zstd_frame.MAX_HUF_BITS and cl[cl > 0].min() == 1
    _check_hufpack(lits, n_lit)
    pieces, = calls
    M = -(-n_pad // entropy_kernel.MAX_STREAM_LITS)
    assert pieces[:, 1].max() == entropy_kernel.MAX_STREAM_LITS
    assert len(pieces) == len(n_lit) * M
    assert pieces[:, 1].reshape(-1, M).sum(1).tolist() == n_lit.tolist()
    assert entropy_kernel.hufpack.LAUNCHES == 0


def test_code_table_refuses_long_codes():
    with pytest.raises(ValueError):
        entropy_kernel.pack_code_table([0, 1], [1, 12])
    assert entropy_kernel.hufpack_frame.LAUNCHES == 0


@pytest.mark.parametrize("n", [0, 1, 40, 63, 64, 500, 1023, 1024, 5000,
                               70000])
def test_encode_literals_match_jax_and_host(n):
    """Literal sections: the JAX package's device stage byte for byte,
    and the host encoder wherever the histogram is exact (n <= 64 KiB)."""
    rng = np.random.default_rng(n)
    lits = structured(n, n)
    if n == 40:
        lits = b"\x07" * n                                   # RLE
    elif n == 500:
        lits = rng.integers(0, 256, n, np.uint8).tobytes()   # raw wins
    got = device_entropy.encode_literals_device(lits, "cpu")
    assert got == jentropy.encode_literals_device(lits)
    if n <= 1 << 16:
        assert got == zstd_frame._encode_literals(lits)


def _frame_sections(seed):
    """A ragged frame's sections: streams of 1 to 32768 literals under
    three tables (a 128 KiB section's four full streams, one literal, a
    ragged four-stream section), and a section with 1-bit and 11-bit
    codes."""
    rng = np.random.default_rng(seed)
    big = _lits(seed, 4, 32768)
    mid = _lits(seed + 1, 1, 1203)[0]
    skew = _lits(seed + 2, 1, 5000, skewed=True)[0]
    cases = [[*big], [big[1, :1]],
             [mid[:301], mid[301:602], mid[602:903], mid[903:]],
             [skew[:1250], skew[1250:2500], skew[2500:3750], skew[3750:]]]
    out = []
    for parts in cases:
        # the one-literal section takes a table of its row's literals
        cv, cl = _codes(big[1:2] if len(parts[0]) == 1
                        else np.concatenate(parts)[None])
        out.append((parts, cv, cl))
    assert max(out[3][2]) == zstd_frame.MAX_HUF_BITS and \
        min(x for x in out[3][2] if x) == 1
    rng.shuffle(out)
    return out


def test_hufpack_frame_plain_matches_streams_xla_and_pallas():
    """hufpack_frame_plain over a ragged frame (several tables, streams of
    1 to 32768 literals, 1-bit and 11-bit codes) equals hufpack_plain per
    stream, the JAX package's XLA scatter oracle and its Pallas kernel in
    interpret mode per section, and the host encoder's stream bits; the
    wrapper on CPU tensors is the plain version and launches nothing."""
    sections = _frame_sections(12)
    jobs = [(parts, entropy_kernel.pack_code_table(cv, cl))
            for parts, cv, cl in sections]
    lits, streams, tables, n_words = entropy_kernel.frame_inputs(jobs)
    assert (streams[:, 0] % entropy_kernel.LIT_ALIGN == 0).all()
    assert len(streams) == 13 and len(tables) == 4
    assert streams[:, 1].min() == 1 and streams[:, 1].max() == 32768
    args = [torch.from_numpy(x) for x in (lits, streams, tables)]
    words, totals = entropy_kernel.hufpack_frame_plain(*args, n_words)
    for g, w in zip(entropy_kernel.hufpack_frame(*args, n_words),
                    (words, totals)):
        assert torch.equal(g, w)
    assert entropy_kernel.hufpack_frame.LAUNCHES == 0
    words = words.numpy().view(np.uint32)
    totals = totals.numpy()
    s = 0
    for parts, cv, cl in sections:
        n_pad = max(jek.MIN_PALLAS_PAD,
                    1 << (max(len(p) for p in parts) - 1).bit_length())
        rows = np.zeros((len(parts), n_pad), np.uint8)
        n_lit = np.array([len(p) for p in parts], np.int32)
        for r, p in enumerate(parts):
            rows[r, :len(p)] = p
        wx, tx = jentropy._make_hufpack_xla(n_pad, 6, len(parts))(
            rows, n_lit, cv, cl)
        wp, tp = jek.make_hufpack_rows_fn(n_pad, len(parts))(
            rows.reshape(-1, 128), n_lit, jek.pack_code_table(cv, cl))
        for r, p in enumerate(parts):
            off, n, k, woff = streams[s]
            W = entropy_kernel.words_per_stream(n)
            got = words[woff:woff + W]
            pw, pt = entropy_kernel.hufpack_plain(
                torch.from_numpy(p[None].copy()),
                torch.tensor([n], dtype=torch.int32), args[2][k])
            np.testing.assert_array_equal(got, pw.numpy()[0].view(np.uint32))
            assert int(totals[s]) == int(pt[0]) == int(tx[r]) == int(tp[r])
            np.testing.assert_array_equal(got, np.asarray(wx)[r, :W])
            np.testing.assert_array_equal(got, np.asarray(wp)[r, :W])
            assert not np.asarray(wx)[r, W:].any()
            host = zstd_frame._huf_encode_stream(p.tobytes(), cv.tolist(),
                                                 cl.tolist())
            w = got.copy()
            w[totals[s] >> 5] |= np.uint32(1 << (totals[s] & 31))
            assert w.tobytes()[: (totals[s] + 8) // 8] == host
            s += 1
    assert s == len(streams)


def test_device_histograms_match_jax_per_section():
    """device_histograms, one call over sections of 64 bytes to 128 KiB
    (exact up to 64 KiB, strided samples past it), equals the JAX
    package's device_histogram section by section."""
    rng = np.random.default_rng(14)
    sizes = [64, 1000, 65536, 65537, 100003, 131072]
    sections = [np.frombuffer(structured(n, n), np.uint8) for n in sizes]
    sections[1] = rng.integers(0, 256, 1000).astype(np.uint8)
    got = device_entropy.device_histograms(sections, "cpu")
    assert got.shape == (len(sizes), 256)
    for g, sec in zip(got, sections):
        np.testing.assert_array_equal(g, jentropy.device_histogram(sec))
    assert device_entropy.device_histograms([], "cpu").shape == (0, 256)


def _mixed_frame(seed):
    """1 MiB in 128 KiB zstd blocks and hand-made sequences covering each
    literal-section kind: text and skewed bytes (Huffman, sampled
    histograms), noise (raw literals, and a raw block: the compressed one
    does not shrink it), 20 literals before a match (short, raw), 30
    equal ones (RLE), an exact repeat (no literals) and a ragged last
    block."""
    rng = np.random.default_rng(seed)
    k = 1 << 17
    text = structured(seed, k)
    skew = rng.choice(256, k, p=np.r_[[0.75], np.full(255, 0.25 / 255)])
    src = b"".join([
        text, rng.integers(0, 256, k, np.uint8).tobytes(),
        rng.integers(0, 256, 20, np.uint8).tobytes() + text[:k - 20],
        bytes([7]) * 30 + text[:k - 30], text, structured(seed + 1, k),
        skew.astype(np.uint8).tobytes(), structured(seed + 2, k - 100)])
    seqs = np.array([(2 * k + 20, 2 * k + 20, k - 20, 0),
                     (3 * k + 30, 30, k - 30, 0), (4 * k, 0, k, 0)],
                    np.uint32)
    return src, seqs


def test_frame_of_every_section_kind_matches_jax_and_decodes():
    """frame_from_sequences on _mixed_frame: byte-identical to the JAX
    package's, decoded by the from-spec decoder and libzstd; the frame
    holds raw, RLE and Huffman literal sections, an empty one and a raw
    block."""
    src, seqs = _mixed_frame(15)
    got = device_entropy.frame_from_sequences(src, seqs, "cpu")
    assert got == jentropy.frame_from_sequences(src, seqs)
    assert zstd_frame.decompress(got, len(src)) == src
    assert zstd.decompress(got, len(src)) == src
    lits = [x for _, _, x in device_entropy.literal_sections(src, seqs)]
    kinds = [s[0] & 3 for s in device_entropy.encode_sections(lits, "cpu")]
    assert set(kinds) == {0, 1, 2} and 0 in map(len, lits)
    assert sorted(map(len, lits))[:3] == [0, 20, 30]
    # block types: a raw block (the noise) among compressed ones
    off = 5 + 4
    types = []
    while True:
        h = int.from_bytes(got[off:off + 3], "little")
        types.append((h >> 1) & 3)
        off += 3 + (h >> 3)
        if h & 1:
            break
    assert types.count(0) == 1 and types.count(2) == 7


def test_frame_runs_one_histogram_call_and_one_pack_launch(monkeypatch):
    """frame_from_sequences of a frame whose sections need tables makes
    one device_histograms call and one hufpack_frame call, as do
    zstd_device.compress_block's frames (one frame each)."""
    calls = {"hist": 0, "pack": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(device_entropy, "device_histograms", counted(
        "hist", device_entropy.device_histograms))
    monkeypatch.setattr(device_entropy, "hufpack_frame", counted(
        "pack", device_entropy.hufpack_frame))
    src, seqs = _mixed_frame(16)
    device_entropy.frame_from_sequences(src, seqs, "cpu")
    assert calls == {"hist": 1, "pack": 1}
    zstd_device.compress_block(structured(17, 3 << 17), device="cpu")
    assert calls == {"hist": 2, "pack": 2}


# ---------------------------------------------------------------------------
# zstd frames and the block codecs
# ---------------------------------------------------------------------------

def _seqs(src):
    """The JAX package's sequences for src, as its zstd device tier finds
    them (a power-of-two padded whole-block window)."""
    npad = 1 << (len(src) - 1).bit_length()
    words = _words(src + bytes(npad - len(src)))
    (apos, aref), = jdm.fast_block_anchors(
        jax.device_put(words), npad // 4, max_offset_words=npad // 4,
        suppress_sampled_chains=False)
    keep = apos < len(src)
    return jzstd_device.sequences_from_anchors(src, apos[keep], aref[keep])


@pytest.mark.parametrize("n", [1 << 17, 300001])
def test_frame_from_sequences_match_jax_and_decode(n):
    src = structured(n, n)
    seqs = _seqs(src)
    got = device_entropy.frame_from_sequences(src, seqs, "cpu")
    assert got == jentropy.frame_from_sequences(src, seqs)
    assert zstd_frame.decompress(got, n) == src
    assert zstd.decompress(got, n) == src
    assert len(got) < n // 2
    blocks = device_entropy._split_blocks(seqs, n)
    assert blocks == jentropy._split_blocks(seqs, n)
    assert sum(b[0] for b in blocks) == n


def _codec_cases():
    rng = np.random.default_rng(21)
    big = 1 << 17
    return {
        "zeros": bytes(big),
        "periodic": (b"the quick brown fox jumps over the lazy.. "
                     * (big // 42 + 1))[:big],
        "tiled": rng.integers(0, 256, 6 << 10, np.uint8).tobytes() * 24,
        "noise": rng.integers(0, 256, big, np.uint8).tobytes(),
        "structured": structured(7, 3 * big),
        "ragged_tail": structured(8, big + 3),
        "sub_64k": rng.integers(0, 256, 1000, np.uint8).tobytes() * 3,
    }


@pytest.mark.parametrize("name", list(_codec_cases()))
def test_zstd_device_codec_matches_jax(name):
    src = _codec_cases()[name]
    got = zstd_device.compress_block(src, device="cpu")
    assert got == jzstd_device.compress_block(src)
    assert zstd.decompress(got, len(src)) == src
    assert zstd_frame.decompress(got, len(src)) == src


@pytest.mark.parametrize("name", list(_codec_cases()))
def test_lz4_device_codec_matches_jax(name):
    src = _codec_cases()[name]
    got = device_lz4.compress_block(src, "cpu")
    assert got == jdevice_lz4.compress_block(src)
    assert lz4.decompress(got, len(src)) == src


def test_zstd_libzstd_tier_matches_jax():
    """entropy="libzstd": ZSTD_compressSequences on the device anchors, or
    host zstd where libzstd lacks it — the JAX package's choice either
    way.  Each package's libzstd context lives per thread and its first
    call emits other (valid) bytes than later ones, so one call warms each
    before the comparison."""
    src = structured(9, 3 << 17)
    jzstd_device.compress_block(src, entropy="libzstd")
    zstd_device.compress_block(src, entropy="libzstd", device="cpu")
    got = zstd_device.compress_block(src, entropy="libzstd", device="cpu")
    assert got == jzstd_device.compress_block(src, entropy="libzstd")
    assert zstd.decompress(got, len(src)) == src


def test_registry_and_store_use_the_codec_device(tmp_path):
    """get_codec(tag, device) compresses like the JAX codec with its
    use_device switch; device None like the host codec; decompression
    and the stored layout are the host's."""
    src = structured(10, 200000)
    zt, lt = C.COMPRESSION_TYPE_ZSTD_DEFAULT, C.COMPRESSION_TYPE_LZ4_DEFAULT
    assert compression_registry.get_codec(zt, "cpu").compress(zt, src) == \
        jzstd_device.compress_block(src, 3)
    assert compression_registry.get_codec(lt).compress(lt, src) == \
        JLz4Codec().compress(lt, src)
    assert compression_registry.get_codec(zt).compress(zt, src) == \
        JZstdCodec().compress(zt, src)
    assert JLz4Codec.use_device is False and JZstdCodec.use_device is False
    assert compression_registry.supported_tags() == \
        jregistry.supported_tags()
    with pytest.raises(KeyError):
        compression_registry.get_codec(0x12345678)


# ---------------------------------------------------------------------------
# the repair: upsync --device writes the JAX package's blocks
# ---------------------------------------------------------------------------

TREE = [("big/pak0.bin", 1_400_000), ("big/pak1.bin", 900_001),
        ("mid.bin", 300_000), ("small.txt", 3000), ("empty", 0)]


def _prose(seed: int, n: int) -> bytes:
    """Words drawn from a small vocabulary: compressible, with skewed
    literals and short matches, but no chunk repeats."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 9), np.uint8))
             for _ in range(300)]
    out = b" ".join(vocab[i] for i in rng.integers(0, 300, n // 3))
    return out[:n]


def _write_tree(root):
    """Prose files, one with a zero run and a repeated span, so that
    dedup leaves several blocks and each tier has matches to find."""
    for k, (rel, n) in enumerate(TREE):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = _prose(k, n)
        if k == 0:
            data = data[:200000] + bytes(30000) + data[:50000] + \
                data[280000:]
        with open(path, "wb") as f:
            f.write(data[:n])


def _files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_upsync_device_codecs_write_the_jax_packages_blocks(
        tmp_path, monkeypatch, codec):
    """The port's upsync with its device codecs on "cpu" and the JAX
    package's device upsync (xp=jnp, use_device switches) write the same
    block files and the same .lvi."""
    import jax.numpy as jnp

    tag = {"zstd": C.COMPRESSION_TYPE_ZSTD_DEFAULT,
           "lz4": C.COMPRESSION_TYPE_LZ4_DEFAULT}[codec]
    kw = dict(target_chunk_size=1024, target_block_size=256 << 10,
              compression_tag=tag)
    fs = FSStorage()
    src = str(tmp_path / "src")
    _write_tree(src)
    store = CompressBlockStore(FSBlockStore(fs, str(tmp_path / "port")),
                               device="cpu")
    vi, _ = api.upsync(fs, src, store, device="cpu", **kw)

    monkeypatch.setattr(JLz4Codec, "use_device", True)
    monkeypatch.setattr(JZstdCodec, "use_device", True)
    jstore = JCompressBlockStore(FSBlockStore(fs, str(tmp_path / "jax")))
    jvi, _ = japi.upsync(fs, src, jstore, xp=jnp, **kw)

    assert vi.to_bytes() == jvi.to_bytes()
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    blocks = [p for p in want if p.endswith(".lrb")]
    assert len(blocks) >= 4
    # every block file byte for byte (the store index lists the blocks
    # in the order the writer threads finished them, so it is not held)
    assert sorted(got) == sorted(want)
    for p in blocks:
        assert got[p] == want[p], p
    # the device tiers ran: a host-codec store would differ
    host = JCompressBlockStore(FSBlockStore(fs, str(tmp_path / "host")))
    monkeypatch.setattr(JLz4Codec, "use_device", False)
    monkeypatch.setattr(JZstdCodec, "use_device", False)
    japi.upsync(fs, src, host, xp=np, **kw)
    host_files = _files(tmp_path / "host")
    assert any(host_files[p] != want[p] for p in blocks)


def test_cli_upsync_opens_the_ports_compress_store(tmp_path, monkeypatch):
    """upsync writes through the port's CompressBlockStore: on the card
    with and without --device, on the CPU with --device cpu, with the host
    codecs with --device host."""
    seen = []

    def fake_upsync(storage, root, store, **kw):
        seen.append((store, kw["device"]))
        raise KeyboardInterrupt

    monkeypatch.setattr(cli.api, "upsync", fake_upsync)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    argv = ["upsync", "--storage-uri", str(tmp_path / "s"),
            "--source-path", str(tmp_path), "--target-path",
            str(tmp_path / "v.lvi")]
    for extra in ([], ["--device"], ["--device", "--hash-algorithm",
                                     "blake2"], ["--device", "cuda"],
                  ["--device", "cpu"], ["--device", "host"]):
        with pytest.raises(KeyboardInterrupt):
            cli.main(argv + extra)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    want = [cuda, cuda, cuda, cuda, cpu, None]
    assert all(isinstance(s, CompressBlockStore) for s, _ in seen)
    assert [s.device for s, _ in seen] == want
    assert [d for _, d in seen] == want


def test_count_launch_loses_no_update_across_threads():
    """write_content's worker threads call the kernel wrappers at once:
    count_launch must lose no increment (more threads than cores, a
    shortened switch interval)."""
    def wrapper():
        pass

    wrapper.LAUNCHES = 0
    n_threads, n_each = 4 * (os.cpu_count() or 1), 2000

    def work():
        for _ in range(n_each):
            _kernels.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.LAUNCHES == n_threads * n_each
