"""The port's device LZ4 decode (``parallel/device_decode.py``) on the
CPU: the parse, the searchsorted expansion and the pointer-jumping
resolve reproduce the host decoder and the JAX package's device decode
byte for byte on tests/test_device_decode.py's cases, the anchor-encoded
block included; an unresolvable pointer raises."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from longtail_tpu.ops import lz4 as jlz4  # noqa: E402
from longtail_tpu.parallel import device_decode as jdd  # noqa: E402
from longtail_tpu_torch.ops import lz4  # noqa: E402
from longtail_tpu_torch.parallel import device_decode as dd  # noqa: E402

torch.set_num_threads(1)


def _cases():
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 256, 6 << 10, np.uint8).tobytes()
    text = (b"the quick brown fox jumps over the lazy dog. " * 3000)
    return [
        ("tiled", (tile * 40)[:200_000]),
        ("text", text[:120_000]),
        ("noise", rng.integers(0, 256, 150_000, np.uint8).tobytes()),
        ("zeros", bytes(100_000)),             # overlapping-match RLE
        ("mix", text[:50_000] + bytes(5000) + tile
         + rng.integers(0, 256, 30_000, np.uint8).tobytes()),
        ("tiny", b"abcabcabcabcabcabc"),
        ("empty", b""),
        ("period3", b"abc" * 40_000),          # offset 3 overlap chains
    ]


def _anchor_block():
    """tests/test_device_decode.py's block of the device anchor encoder:
    24 KiB tile repeats, an anchor every 256 bytes."""
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes()
    raw = (tile * 20)[:300_000]
    pos = np.arange(24 << 10, len(raw) - 64, 256, dtype=np.int64)
    return raw, pos, pos - (24 << 10)


@pytest.mark.parametrize("name,raw", _cases(), ids=[c[0] for c in _cases()])
def test_decode_equals_host_and_jax(name, raw):
    comp = lz4.compress(raw)
    got = dd.decode_block_device(comp, len(raw), device="cpu")
    assert got == raw == lz4.decompress(comp, len(raw))
    assert got == jdd.decode_block_device(comp, len(raw))


def test_anchor_encoded_block_decodes():
    raw, pos, ref = _anchor_block()
    comp = lz4.assemble_anchors(raw, pos, ref)
    assert comp == jlz4.assemble_anchors(raw, pos, ref)
    got = dd.decode_block_device(comp, len(raw), device="cpu")
    assert got == raw == jdd.decode_block_device(comp, len(raw))


@pytest.mark.parametrize("name", ["mix", "period3", "anchors"])
def test_parse_and_padded_resolve_equal_the_jax_packages(name):
    """parse_sequences equals the JAX one (values and dtypes), and
    make_resolve_fn on the JAX package's power-of-two padded inputs gives
    its output bytes and its round count."""
    if name == "anchors":
        raw, pos, ref = _anchor_block()
        comp = lz4.assemble_anchors(raw, pos, ref)
    else:
        raw = dict(_cases())[name]
        comp = lz4.compress(raw)
    seq = dd.parse_sequences(comp, len(raw))
    for a, b in zip(seq, jdd.parse_sequences(comp, len(raw)), strict=True):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert int((seq[2] + seq[5]).sum()) == len(raw)
    n_seq = 1 << max(4, (len(seq[0]) - 1).bit_length())
    n_out = 1 << max(8, (len(raw) - 1).bit_length())
    comp_a = np.zeros(1 << max(8, (len(comp) - 1).bit_length()), np.uint8)
    comp_a[:len(comp)] = np.frombuffer(comp, np.uint8)
    pad = np.zeros(n_seq - len(seq[0]), np.int32)
    args = [np.concatenate([a, pad + np.int32(fill)]) for a, fill in
            zip(seq, (0, len(raw), 0, len(raw), 0, 0))]
    want, jrounds = jdd.make_resolve_fn(n_out, n_seq)(comp_a, *args)
    got, rounds = dd.make_resolve_fn(n_out, n_seq)(
        torch.from_numpy(comp_a), *(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(jrounds) <= dd.max_rounds(n_out)
    assert got.numpy()[:len(raw)].tobytes() == raw


def test_deep_chain_resolves_within_the_round_limit():
    """Matches that copy earlier matches (a chain through every 64-byte
    period) take several rounds, all within max_rounds."""
    rng = np.random.default_rng(9)
    unit = rng.integers(0, 256, 64, np.uint8).tobytes()
    raw = unit + b"".join(bytes([i]) + unit[1:] for i in range(1, 200))
    comp = lz4.compress(raw)
    seq = dd.parse_sequences(comp, len(raw))
    fn = dd.make_resolve_fn(len(raw), len(seq[0]))
    out, rounds = fn(torch.frombuffer(bytearray(comp), dtype=torch.uint8),
                     *(torch.from_numpy(a) for a in seq))
    assert out.numpy().tobytes() == raw
    assert 2 < rounds <= dd.max_rounds(len(raw))


def test_unresolvable_pointer_raises():
    """A match before any literal points at itself: the resolve raises
    after max_rounds instead of decoding on the host."""
    seq = [torch.tensor([v], dtype=torch.int32) for v in (0, 0, 0, 0, 1, 8)]
    fn = dd.make_resolve_fn(8, 1)
    with pytest.raises(RuntimeError, match="unresolved after 4 rounds"):
        fn(torch.zeros(4, dtype=torch.uint8), *seq)
