"""MeowHash 0.5/calico, implemented from the algorithm definition with
software AES (no AES-NI requirement, no upstream code).

The reference wraps Casey Muratori's meow_hash (x64 AES-NI only — the
reference itself drops it on arm64, CHANGELOG 0.4.0) as hash type 'meow'
(lib/meowhash/longtail_meowhash.c:7) and takes the low 64 bits of the
128-bit digest (:48).  MeowHash 0.5 is eight 128-bit lanes seeded from an
encoding of Pi, mixed with single AES decryption rounds (aesdec), 64-bit
lane adds and xors over 256-byte blocks, a masked residual + message-length
injection, and a 12-round shuffle/fold mixdown.

Conformance: the reference suite's known answer (test/test.cpp:476-485)
and .lvi-level interop in tests/test_interop.py when a reference binary is
present.  This is a parity/compat hash; BLAKE3 is the production path.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1
_M128 = (1 << 128) - 1

# "nothing-up-our-sleeves" default seed: the first 128 bytes of an encoding
# of Pi (binary expansion), as published with the algorithm
MEOW_DEFAULT_SEED = bytes((
    0x32, 0x43, 0xF6, 0xA8, 0x88, 0x5A, 0x30, 0x8D,
    0x31, 0x31, 0x98, 0xA2, 0xE0, 0x37, 0x07, 0x34,
    0x4A, 0x40, 0x93, 0x82, 0x22, 0x99, 0xF3, 0x1D,
    0x00, 0x82, 0xEF, 0xA9, 0x8E, 0xC4, 0xE6, 0xC8,
    0x94, 0x52, 0x82, 0x1E, 0x63, 0x8D, 0x01, 0x37,
    0x7B, 0xE5, 0x46, 0x6C, 0xF3, 0x4E, 0x90, 0xC6,
    0xCC, 0x0A, 0xC2, 0x9B, 0x7C, 0x97, 0xC5, 0x0D,
    0xD3, 0xF8, 0x4D, 0x5B, 0x5B, 0x54, 0x70, 0x91,
    0x79, 0x21, 0x6D, 0x5D, 0x98, 0x97, 0x9F, 0xB1,
    0xBD, 0x13, 0x10, 0xBA, 0x69, 0x8D, 0xFB, 0x5A,
    0xC2, 0xFF, 0xD7, 0x2D, 0xBD, 0x01, 0xAD, 0xFB,
    0x7B, 0x8E, 0x1A, 0xFE, 0xD6, 0xA2, 0x67, 0xE9,
    0x6B, 0xA7, 0xC9, 0x04, 0x5F, 0x12, 0xC7, 0xF9,
    0x92, 0x4A, 0x19, 0x94, 0x7B, 0x39, 0x16, 0xCF,
    0x70, 0x80, 0x1F, 0x2E, 0x28, 0x58, 0xEF, 0xC1,
    0x66, 0x36, 0x92, 0x0D, 0x87, 0x15, 0x74, 0xE6,
))


# ---------------------------------------------------------------------------
# software AES single decryption round (aesdec), tables built from the
# GF(2^8) definitions rather than embedded
# ---------------------------------------------------------------------------

def _gf_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return out


def _build_tables():
    # forward S-box: multiplicative inverse then the affine transform
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    sbox = [0] * 256
    for x in range(256):
        b = inv[x]
        r = 0
        for i in range(8):
            bit = ((b >> i) ^ (b >> ((i + 4) % 8)) ^ (b >> ((i + 5) % 8))
                   ^ (b >> ((i + 6) % 8)) ^ (b >> ((i + 7) % 8))
                   ^ (0x63 >> i)) & 1
            r |= bit << i
        sbox[x] = r
    inv_sbox = [0] * 256
    for x, v in enumerate(sbox):
        inv_sbox[v] = x
    # InvMixColumns as four 256-entry tables of 32-bit column contributions
    imc = []
    for coefs in ((14, 9, 13, 11), (11, 14, 9, 13),
                  (13, 11, 14, 9), (9, 13, 11, 14)):
        imc.append([_gf_mul(coefs[0], v) | (_gf_mul(coefs[1], v) << 8)
                    | (_gf_mul(coefs[2], v) << 16)
                    | (_gf_mul(coefs[3], v) << 24) for v in range(256)])
    return inv_sbox, imc


_INV_SBOX, _IMC = _build_tables()

# InvShiftRows byte source map: output byte (col*4+row) comes from input
# byte of row `row`, column (col - row) mod 4... inverse shift = rotate
# each row right by its index.
_ISR = [0] * 16
for col in range(4):
    for row in range(4):
        _ISR[col * 4 + row] = ((col - row) % 4) * 4 + row


def _aesdec(state: int, key: int) -> int:
    b = state.to_bytes(16, "little")
    s = [_INV_SBOX[b[_ISR[i]]] for i in range(16)]
    out = 0
    for col in range(4):
        w = (_IMC[0][s[col * 4]] ^ _IMC[1][s[col * 4 + 1]]
             ^ _IMC[2][s[col * 4 + 2]] ^ _IMC[3][s[col * 4 + 3]])
        out |= w << (32 * col)
    return out ^ key


def _paddq(a: int, b: int) -> int:
    lo = ((a & _M64) + (b & _M64)) & _M64
    hi = ((a >> 64) + (b >> 64)) & _M64
    return (hi << 64) | lo


def _palignr(hi: int, lo: int, n: int) -> int:
    return (((hi << 128) | lo) >> (8 * n)) & _M128


def _load(buf: bytes, off: int) -> int:
    return int.from_bytes(buf[off:off + 16], "little")


# ---------------------------------------------------------------------------
# the hash
# ---------------------------------------------------------------------------

def _mix_reg(x, r1, r2, r3, r4, r5, i1, i2, i3, i4):
    x[r1] = _aesdec(x[r1], x[r2])
    x[r3] = _paddq(x[r3], i1)
    x[r2] ^= i2
    x[r2] = _aesdec(x[r2], x[r4])
    x[r5] = _paddq(x[r5], i3)
    x[r4] ^= i4


def _mix(x, r1, r2, r3, r4, r5, buf, ptr):
    _mix_reg(x, r1, r2, r3, r4, r5,
             _load(buf, ptr + 15), _load(buf, ptr + 0),
             _load(buf, ptr + 1), _load(buf, ptr + 16))


def _shuffle(x, r1, r2, r3, r4, r5, r6):
    x[r1] = _aesdec(x[r1], x[r4])
    x[r2] = _paddq(x[r2], x[r5])
    x[r4] ^= x[r6]
    x[r4] = _aesdec(x[r4], x[r2])
    x[r5] = _paddq(x[r5], x[r6])
    x[r2] ^= x[r3]


_MIX_PATTERNS = (
    (0, 4, 6, 1, 2), (1, 5, 7, 2, 3), (2, 6, 0, 3, 4), (3, 7, 1, 4, 5),
    (4, 0, 2, 5, 6), (5, 1, 3, 6, 7), (6, 2, 4, 7, 0), (7, 3, 5, 0, 1),
)


def meow_hash128(data: bytes, seed: bytes = MEOW_DEFAULT_SEED) -> int:
    n = len(data)
    x = [_load(seed, 16 * i) for i in range(8)]

    # full 256-byte blocks
    ptr = 0
    for _ in range(n >> 8):
        for k, pat in enumerate(_MIX_PATTERNS):
            _mix(x, *pat, data, ptr + 0x20 * k)
        ptr += 0x100

    # residual <32 bytes: the sub-16 tail (masked) and the aligned 16
    last = n & ~0xF
    len8 = n & 0xF
    xmm9 = int.from_bytes(data[last:last + len8], "little") if len8 else 0
    xmm11 = 0
    if n & 0x10:
        xmm11 = xmm9
        xmm9 = _load(data, last - 0x10)
    xmm8 = _palignr(xmm9, xmm11, 15)
    xmm10 = _palignr(xmm9, xmm11, 1)

    # length injection
    xmm15 = n & _M128
    xmm12 = _palignr(0, xmm15, 15)
    xmm14 = _palignr(0, xmm15, 1)

    _mix_reg(x, 0, 4, 6, 1, 2, xmm8, xmm9, xmm10, xmm11)
    _mix_reg(x, 1, 5, 7, 2, 3, xmm12, 0, xmm14, xmm15)

    # full 32-byte blocks after the 256-blocks (up to 7)
    lane_count = (n >> 5) & 0x7
    for k in range(lane_count):
        _mix(x, *_MIX_PATTERNS[(2 + k) % 8], data, ptr + 0x20 * k)

    # mixdown: 12 shuffles then fold
    for pat in ((0, 1, 2, 4, 5, 6), (1, 2, 3, 5, 6, 7), (2, 3, 4, 6, 7, 0),
                (3, 4, 5, 7, 0, 1), (4, 5, 6, 0, 1, 2), (5, 6, 7, 1, 2, 3),
                (6, 7, 0, 2, 3, 4), (7, 0, 1, 3, 4, 5), (0, 1, 2, 4, 5, 6),
                (1, 2, 3, 5, 6, 7), (2, 3, 4, 6, 7, 0), (3, 4, 5, 7, 0, 1)):
        _shuffle(x, *pat)

    x[0] = _paddq(x[0], x[2])
    x[1] = _paddq(x[1], x[3])
    x[4] = _paddq(x[4], x[6])
    x[5] = _paddq(x[5], x[7])
    x[0] ^= x[1]
    x[4] ^= x[5]
    return _paddq(x[0], x[4])


def hash64(data: bytes) -> int:
    """The longtail 64-bit meow hash: low u64 of the 128-bit digest
    (lib/meowhash/longtail_meowhash.c:48)."""
    return meow_hash128(data) & _M64


# ---------------------------------------------------------------------------
# numpy-batched form: N chunks hashed in lockstep (lanes, 16)-u8 states
# ---------------------------------------------------------------------------

_INV_SBOX_NP = None
_IMC_NP = None
_ISR_NP = None


def _np_tables():
    global _INV_SBOX_NP, _IMC_NP, _ISR_NP
    import numpy as np

    if _INV_SBOX_NP is None:
        _INV_SBOX_NP = np.array(_INV_SBOX, dtype=np.uint8)
        _IMC_NP = [np.array(t, dtype=np.uint32) for t in _IMC]
        _ISR_NP = np.array(_ISR, dtype=np.intp)
    return _INV_SBOX_NP, _IMC_NP, _ISR_NP


def _aesdec_np(state, key):
    """(N, 16) u8 batched x86 AESDEC (InvShiftRows + InvSubBytes +
    InvMixColumns + xor key), same tables as the scalar path."""
    import numpy as np

    inv_sbox, imc, isr = _np_tables()
    s = inv_sbox[state[:, isr]]                    # (N, 16)
    cols = s.reshape(-1, 4, 4).astype(np.intp)     # (N, 4 cols, 4 rows)
    w = (imc[0][cols[:, :, 0]] ^ imc[1][cols[:, :, 1]]
         ^ imc[2][cols[:, :, 2]] ^ imc[3][cols[:, :, 3]])   # (N, 4) u32
    out = np.ascontiguousarray(w.astype("<u4")).view(np.uint8)
    return out.reshape(-1, 16) ^ key


def _paddq_np(a, b):
    import numpy as np

    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    return (a.view("<u8") + b.view("<u8")).view(np.uint8)


def _mix_reg_np(x, r1, r2, r3, r4, r5, i1, i2, i3, i4, mask=None):
    n1 = _aesdec_np(x[r1], x[r2])
    n3 = _paddq_np(x[r3], i1)
    n2 = _aesdec_np(x[r2] ^ i2, x[r4])
    n5 = _paddq_np(x[r5], i3)
    n4 = x[r4] ^ i4
    if mask is None:
        x[r1], x[r2], x[r3], x[r4], x[r5] = n1, n2, n3, n4, n5
    else:
        import numpy as np

        m = mask[:, None]
        x[r1] = np.where(m, n1, x[r1])
        x[r2] = np.where(m, n2, x[r2])
        x[r3] = np.where(m, n3, x[r3])
        x[r4] = np.where(m, n4, x[r4])
        x[r5] = np.where(m, n5, x[r5])


def _shuffle_np(x, r1, r2, r3, r4, r5, r6):
    n1 = _aesdec_np(x[r1], x[r4])
    t2 = _paddq_np(x[r2], x[r5])      # r2 after its paddq, before ^= r3
    n4 = _aesdec_np(x[r4] ^ x[r6], t2)
    n5 = _paddq_np(x[r5], x[r6])
    x[r1], x[r2], x[r4], x[r5] = n1, t2 ^ x[r3], n4, n5


def hash_chunks_batched(data_u8, lengths):
    """Batched MeowHash-64 over (N, L) u8 rows with per-row lengths —
    the lockstep replacement for the per-chunk Python loop: all lanes'
    256-byte blocks absorb together (masked past each lane's block
    count), the per-lane residual/length injections are prepared with
    the scalar helpers (O(1) each), and the tail 32-byte blocks gather
    at per-lane offsets.  Bit-identical to meow_hash128 per lane."""
    import numpy as np

    data = np.ascontiguousarray(data_u8, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    N, L = data.shape
    if N == 0:
        return np.zeros(0, dtype=np.uint64)
    pad = np.zeros((N, 48), np.uint8)   # absorb windows read past L
    data = np.concatenate([data, pad], axis=1)

    seed = np.frombuffer(MEOW_DEFAULT_SEED, np.uint8)
    x = [np.broadcast_to(seed[16 * i:16 * i + 16], (N, 16)).copy()
         for i in range(8)]

    nblk = lengths >> 8
    max_blk = int(nblk.max())
    for b in range(max_blk):
        mask = nblk > b
        base = b << 8
        for k, (r1, r2, r3, r4, r5) in enumerate(_MIX_PATTERNS):
            p = base + 0x20 * k
            _mix_reg_np(x, r1, r2, r3, r4, r5,
                        data[:, p + 15:p + 31], data[:, p:p + 16],
                        data[:, p + 1:p + 17], data[:, p + 16:p + 32],
                        mask=mask)

    # per-lane residual + length injection values via the scalar helpers
    inj = np.zeros((8, N, 16), np.uint8)
    for i in range(N):
        n = int(lengths[i])
        row = data[i]
        last = n & ~0xF
        len8 = n & 0xF
        xmm9 = int.from_bytes(row[last:last + len8].tobytes(), "little") \
            if len8 else 0
        xmm11 = 0
        if n & 0x10:
            xmm11 = xmm9
            xmm9 = int.from_bytes(row[last - 0x10:last].tobytes(), "little")
        vals = (_palignr(xmm9, xmm11, 15), xmm9,
                _palignr(xmm9, xmm11, 1), xmm11,
                _palignr(0, n & _M128, 15), 0,
                _palignr(0, n & _M128, 1), n & _M128)
        for j, v in enumerate(vals):
            inj[j, i] = np.frombuffer(
                int(v).to_bytes(16, "little"), np.uint8)
    _mix_reg_np(x, 0, 4, 6, 1, 2, inj[0], inj[1], inj[2], inj[3])
    _mix_reg_np(x, 1, 5, 7, 2, 3, inj[4], inj[5], inj[6], inj[7])

    # up to 7 trailing 32-byte blocks at per-lane offsets
    lane_count = (lengths >> 5) & 0x7
    ptr = (nblk << 8).astype(np.int64)
    col = np.arange(16, dtype=np.int64)
    for k in range(int(lane_count.max()) if N else 0):
        mask = lane_count > k
        base = ptr + 0x20 * k

        def win(off):
            idx = (base + off)[:, None] + col[None, :]
            # masked-out lanes may index past their row; clamp (values
            # unused)
            idx = np.minimum(idx, data.shape[1] - 1)
            return np.take_along_axis(data, idx, axis=1)

        r1, r2, r3, r4, r5 = _MIX_PATTERNS[(2 + k) % 8]
        _mix_reg_np(x, r1, r2, r3, r4, r5,
                    win(15), win(0), win(1), win(16), mask=mask)

    for pat in ((0, 1, 2, 4, 5, 6), (1, 2, 3, 5, 6, 7), (2, 3, 4, 6, 7, 0),
                (3, 4, 5, 7, 0, 1), (4, 5, 6, 0, 1, 2), (5, 6, 7, 1, 2, 3),
                (6, 7, 0, 2, 3, 4), (7, 0, 1, 3, 4, 5), (0, 1, 2, 4, 5, 6),
                (1, 2, 3, 5, 6, 7), (2, 3, 4, 6, 7, 0), (3, 4, 5, 7, 0, 1)):
        _shuffle_np(x, *pat)

    x0 = _paddq_np(x[0], x[2])
    x1 = _paddq_np(x[1], x[3])
    x4 = _paddq_np(x[4], x[6])
    x5 = _paddq_np(x[5], x[7])
    lo = _paddq_np(x0 ^ x1, x4 ^ x5)
    return lo[:, :8].copy().view("<u8").reshape(-1).astype(np.uint64)
