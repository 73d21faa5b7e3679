"""The Huffman pack's (S, n_pad) interface on rows of any length: the
plain version of its kernels (``entropy_kernel.hufpack_pieces_plain``,
packing the pieces of ``row_pieces``) held against the contract
(``hufpack_plain``), the JAX package's XLA scatter oracle, its Pallas
kernel in interpret mode (where its tiling holds) and the host encoder;
and the piece list against a numpy reckoning.  Every comparison is exact
(integers, tolerance 0)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from longtail_tpu.ops import device_entropy as jentropy  # noqa: E402
from longtail_tpu.ops import entropy_kernel as jek  # noqa: E402
from longtail_tpu.ops import zstd_frame  # noqa: E402
from longtail_tpu_torch.ops import entropy_kernel  # noqa: E402

torch.set_num_threads(1)

L = entropy_kernel.MAX_STREAM_LITS


def _rows(seed, n_lit, n_pad, skewed):
    """Rows of n_pad literal slots, zero past n_lit, and their code
    (val, len) from the histogram of the rows before that: skewed rows
    hold byte 0 most of the time, 20 bytes 100 times and the rest once a
    tile (1-bit and 11-bit codes); the others text-like bytes."""
    rng = np.random.default_rng(seed)
    if skewed:
        tile = np.repeat(np.arange(256), np.r_[[12000], np.full(20, 100),
                                               np.ones(235, np.int64)])
        lits = np.stack([np.resize(rng.permutation(tile), n_pad)
                         for _ in n_lit])
    else:
        p = np.r_[np.full(8, 0.09), np.full(248, 0.28 / 248)]
        lits = rng.choice(np.arange(256), size=(len(n_lit), n_pad), p=p)
    lits = lits.astype(np.uint8)
    _, code_val, code_len = zstd_frame.build_huffman(
        np.bincount(lits.reshape(-1), minlength=256).tolist())
    cv = np.zeros(256, np.int32)
    cl = np.zeros(256, np.int32)
    cv[: len(code_val)] = code_val
    cl[: len(code_len)] = code_len
    for i, n in enumerate(n_lit):
        lits[i, n:] = 0
    return lits, cv, cl


def _reference_pieces(n_lit, n_pad):
    """The piece list by hand: M pieces a row, piece m at literal m * L
    of its row, holding the row's literals in [m * L, (m + 1) * L)."""
    M = max(1, -(-n_pad // L))
    rows = []
    for s, n in enumerate(n_lit):
        for m in range(M):
            first = m * L
            rows.append((s * n_pad + first,
                         max(0, min(L, min(n, n_pad) - first)), s,
                         M - 1 - m))
    return np.array(rows, np.int32).reshape(-1, 4)


@pytest.mark.parametrize("n_pad,n_lit,skewed", [
    (65536, [65536], False),
    (2 * 32768 + 4096, [69632, 33000, 5], True),
    (131072, [131072, 131072 - 77], True),
    (4096, [0], False),
    (L, [L, 0, 3, L - 1], False),
    (L + 16, [L + 16, 0, L + 3, 16], True),
])
def test_pieces_plain_matches_contract_xla_pallas_and_host(n_pad, n_lit,
                                                           skewed):
    """Rows of one, several and no pieces' worth of literals, rows of
    n_lit 0, n_pad at one piece and one piece + 16: the plain version of
    the rows kernel equals hufpack_plain, the XLA oracle, the Pallas
    kernel in interpret mode (where its row tile divides the rows: not
    at 69632) and the host encoder, bit for bit."""
    n_lit = np.array(n_lit, np.int32)
    lits, cv, cl = _rows(n_pad + len(n_lit), n_lit, n_pad, skewed)
    if skewed:
        assert cl.max() == zstd_frame.MAX_HUF_BITS and \
            cl[cl > 0].min() == 1
    _check_all(lits, n_lit, cv, cl)


def _check_all(lits, n_lit, cv, cl, host=True):
    """The plain version of the rows kernel against hufpack_plain, the
    XLA oracle, the Pallas kernel in interpret mode where its tiling
    holds, and (host) the host encoder."""
    n_pad = lits.shape[1]
    table = torch.from_numpy(entropy_kernel.pack_code_table(cv, cl))
    args = (torch.from_numpy(lits), torch.from_numpy(n_lit), table)
    words, totals = entropy_kernel.hufpack_pieces_plain(*args)
    want_w, want_t = entropy_kernel.hufpack_plain(*args)
    assert torch.equal(words, want_w) and torch.equal(totals, want_t)
    words = words.numpy().view(np.uint32)
    totals = totals.numpy()
    S = len(n_lit)
    wx, tx = jentropy._make_hufpack_xla(n_pad, 6, S)(lits, n_lit, cv, cl)
    np.testing.assert_array_equal(words, np.asarray(wx))
    np.testing.assert_array_equal(totals, np.asarray(tx))
    if n_pad % 128 == 0 and n_pad >= jek.MIN_PALLAS_PAD and \
            (n_pad // 128) % jek._row_tile(n_pad) == 0:
        wp, tp = jek.make_hufpack_rows_fn(n_pad, S)(
            lits.reshape(-1, 128), n_lit, jek.pack_code_table(cv, cl))
        np.testing.assert_array_equal(totals, np.asarray(tp))
        np.testing.assert_array_equal(
            words, np.asarray(wp)[:, :words.shape[1]])
    for s in range(S if host else 0):
        t = int(totals[s])
        want = zstd_frame._huf_encode_stream(
            lits[s, :n_lit[s]].tobytes(), cv.tolist(), cl.tolist())
        w = words[s].copy()
        w[t >> 5] |= np.uint32(1 << (t & 31))
        assert w.tobytes()[: (t + 8) // 8] == want


def _piece_bits(lits, n_lit, cl):
    """Bits of each piece of each row: (S, M) numpy."""
    S, n_pad = lits.shape
    M = entropy_kernel.pieces_per_row(n_pad)
    live = np.arange(n_pad)[None, :] < np.asarray(n_lit)[:, None]
    per = np.where(live, cl[lits], 0)
    per = np.pad(per, ((0, 0), (0, M * L - n_pad)))
    return per.reshape(S, M, -1).sum(2)


def test_a_last_piece_of_fewer_than_32_bits():
    """Rows whose last non-empty piece holds a few literals, under 32
    bits: its bits share a word with the piece above, which stores it."""
    n_lit = np.array([2 * L + 3, L + 1, 3 * L], np.int32)
    lits, cv, cl = _rows(21, n_lit, 3 * L, True)
    bits = _piece_bits(lits, n_lit, cl)
    assert 0 < bits[0, 2] < 32 and 0 < bits[1, 1] < 32
    _check_all(lits, n_lit, cv, cl)


def test_pieces_of_zero_bits_share_one_word():
    """0-bit codes (pack_code_table takes them): whole pieces of no bits
    between a few bits at each end of a row, so four pieces' bits meet in
    one word, and a row of no bits at all."""
    n_pad = 4 * L
    n_lit = np.array([3 * L + 5, n_pad, 2 * L], np.int32)
    rng = np.random.default_rng(3)
    lits = np.zeros((3, n_pad), np.uint8)
    lits[:, :4] = rng.integers(1, 4, (3, 4))
    lits[:2, 3 * L:3 * L + 5] = rng.integers(1, 4, (2, 5))
    lits[2] = 0
    cv = np.zeros(256, np.int32)
    cl = np.zeros(256, np.int32)
    cv[1:4], cl[1:4] = [0, 2, 3], [1, 2, 2]
    bits = _piece_bits(lits, n_lit, cl)
    assert bits[0, 1] == bits[0, 2] == 0 and 0 < bits[0].sum() < 32
    assert not bits[2].any()
    _check_all(lits, n_lit, cv, cl)


def test_rows_of_more_than_16_pieces():
    """17 pieces a row, past the 16 blocks a thread-block cluster could
    hold, one row's last non-empty piece holding 2 literals: equal to
    hufpack_plain and the XLA oracle (the host encoder takes seconds a
    row here)."""
    n_pad = 16 * L + 16
    n_lit = np.array([n_pad - 7, 16 * L + 2 - L], np.int32)
    lits, cv, cl = _rows(17, n_lit, n_pad, True)
    assert entropy_kernel.pieces_per_row(n_pad) == 17
    _check_all(lits, n_lit, cv, cl, host=False)


@pytest.mark.parametrize("n_pad,n_lit", [
    (16, [0, 16]), (4096, [4096, 17, 0]), (L, [L, L - 1]),
    (L + 16, [L + 16, L, L + 1]), (131072, [131072, 98304 + 31, 5, 0]),
    (1 << 20, [(1 << 20) - 5, 300001]),
])
def test_row_pieces_match_a_numpy_reckoning(n_pad, n_lit):
    """Pieces per row, their first literals, literal counts, rows and the
    count of later pieces; n_lit past n_pad is clamped to it."""
    got = entropy_kernel.row_pieces(torch.tensor(n_lit, dtype=torch.int32),
                                    n_pad).numpy()
    assert got.dtype == np.int32
    assert len(got) == len(n_lit) * entropy_kernel.pieces_per_row(n_pad)
    np.testing.assert_array_equal(got, _reference_pieces(n_lit, n_pad))
    over = entropy_kernel.row_pieces(
        torch.tensor([n_pad + 999], dtype=torch.int32), n_pad).numpy()
    np.testing.assert_array_equal(over, _reference_pieces([n_pad], n_pad))


def test_one_megabyte_rows_equal_the_contract():
    """Two ragged rows of 1 MiB (32 pieces each, well past any zstd
    block) with 1-bit and 11-bit codes: the pieces' version equals
    hufpack_plain and the XLA oracle (the host encoder takes ~14 s a
    row here; the cases above hold the pieces to it)."""
    n_lit = np.array([(1 << 20) - 5, 300001], np.int32)
    lits, cv, cl = _rows(5, n_lit, 1 << 20, True)
    table = torch.from_numpy(entropy_kernel.pack_code_table(cv, cl))
    args = (torch.from_numpy(lits), torch.from_numpy(n_lit), table)
    words, totals = entropy_kernel.hufpack_pieces_plain(*args)
    want_w, want_t = entropy_kernel.hufpack_plain(*args)
    assert torch.equal(words, want_w) and torch.equal(totals, want_t)
    wx, tx = jentropy._make_hufpack_xla(1 << 20, 6, 2)(lits, n_lit, cv, cl)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(wx))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(tx))


@pytest.mark.parametrize("n_pad", [0, 24, 100])
def test_rows_must_be_positive_multiples_of_sixteen(n_pad):
    lits = torch.zeros((2, n_pad), dtype=torch.uint8)
    n_lit = torch.zeros((2,), dtype=torch.int32)
    table = torch.zeros((256,), dtype=torch.int32)
    for fn in (entropy_kernel.hufpack, entropy_kernel.hufpack_pieces_plain):
        with pytest.raises(ValueError):
            fn(lits, n_lit, table)
