"""From-spec RFC 7932 (brotli) decoder.

The reference always ships brotli (vendored 1.1, wrapped at
lib/brotli/longtail_brotli.c:24-74), so reference-written stores can
carry ``btl*``-tagged blocks.  Our production binding is the system
libbrotli (ops/brotli.py); THIS module is the interop floor: a pure-
Python decoder written to RFC 7932 so brotli-tagged stores stay
readable on hosts with no libbrotli at all.  Spec-defined constants
(static dictionary, context tables, word transforms) live in
ops/brotli_data.py.

Structure of the format, section numbers per RFC 7932:
- stream header: WBITS (§9.1)
- per meta-block: header (§9.2) with block-type/count codes per
  category (literals / insert&copy / distances), distance parameters
  NPOSTFIX/NDIRECT, literal context modes, context maps (§7.3) and the
  prefix-code families (§3.2-3.5)
- command loop (§9.3): insert&copy commands, context-modeled literals
  (§7.1), distance ring buffer (§4), static dictionary references with
  word transforms (§8, appendix B)

Throughput is a few MB/s (Python) — decompression correctness floor,
not a hot path; the registry prefers libbrotli when present.

Unlike the JAX package's copy, a corrupt stream fails with one error
type, ``BrotliError``, and the output stops growing once it would pass
``raw_size``: a meta-block longer than what is left of ``raw_size``, or a
command longer than what is left of its meta-block, is rejected before
it is written.
Conformance: tests/test_brotli.py round-trips libbrotli-encoded data
at every quality tier and window, including dictionary-transform-heavy
small text.
"""

from __future__ import annotations

from longtail_tpu_torch.ops.brotli_data import (
    CONTEXT_LUT,
    DICT_NDBITS,
    DICT_OFFSETS,
    TRANSFORMS,
    dictionary,
)


class BrotliError(ValueError):
    pass


# --- spec constant tables (RFC 7932 §3.5, §5, §6) ----------------------

_CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# fixed prefix code for code-length code lengths, keyed by a 4-bit peek
_CL_PREFIX_LEN = (2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4)
_CL_PREFIX_VAL = (0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5)

_BLOCK_LEN_BASE = (1, 5, 9, 13, 17, 25, 33, 41, 49, 65, 81, 97, 113, 145,
                   177, 209, 241, 305, 369, 497, 753, 1265, 2289, 4337,
                   8433, 16625)
_BLOCK_LEN_EXTRA = (2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6,
                    7, 8, 9, 10, 11, 12, 13, 24)

_INSERT_BASE = (0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26, 34, 50, 66, 98,
                130, 194, 322, 578, 1090, 2114, 6210, 22594)
_INSERT_EXTRA = (0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8,
                 9, 10, 12, 14, 24)
_COPY_BASE = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70,
              102, 134, 198, 326, 582, 1094, 2118)
_COPY_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7,
               8, 9, 10, 24)
# (insert range, copy range) per 64-command cell of the 704-symbol
# insert&copy alphabet (§5); cells 0 and 1 imply distance code 0
_INS_RANGE = (0, 0, 0, 0, 1, 1, 0, 2, 1, 2, 2)
_CPY_RANGE = (0, 1, 0, 1, 0, 1, 2, 0, 2, 1, 2)


class _Bits:
    """LSB-first bit reader; peeks past the end read as zero bits."""

    __slots__ = ("data", "n", "byte", "buf", "cnt")

    def __init__(self, data):
        self.data = data
        self.n = len(data)
        self.byte = 0          # next byte to load
        self.buf = 0           # pending bits, LSB = next
        self.cnt = 0

    def _fill(self, need):
        while self.cnt < need and self.byte < self.n:
            self.buf |= self.data[self.byte] << self.cnt
            self.byte += 1
            self.cnt += 8

    def peek(self, n):
        self._fill(n)
        return self.buf & ((1 << n) - 1)

    def drop(self, n):
        self.buf >>= n
        self.cnt -= n
        if self.cnt < 0:       # consumed zero padding past the end
            if self.byte < self.n or self.cnt < -64:
                raise BrotliError("bit reader desync")
            self.cnt = 0
            self.buf = 0

    def read(self, n):
        if n == 0:
            return 0
        v = self.peek(n)
        self.drop(n)
        return v

    def align(self):
        pad = self.cnt & 7
        if pad:
            if self.read(pad) != 0:
                raise BrotliError("nonzero padding")

    def read_bytes(self, n):
        if self.cnt & 7:
            raise BrotliError("read_bytes while unaligned")
        head = bytearray()
        while self.cnt >= 8 and n > 0:
            head.append(self.buf & 0xFF)       # drain pre-loaded bytes
            self.buf >>= 8
            self.cnt -= 8
            n -= 1
        start = self.byte
        if start + n > self.n:
            raise BrotliError("truncated uncompressed block")
        self.byte += n
        return bytes(head) + bytes(self.data[start:start + n])


class _Code:
    """A prefix code as a flat LSB-window lookup table."""

    __slots__ = ("maxlen", "lens", "syms", "single")

    def __init__(self, entries):
        """entries: list of (symbol, length, code) with MSB-first code
        values; a single entry means a zero-bit always-symbol code."""
        if len(entries) == 1:
            self.single = entries[0][0]
            self.maxlen = 0
            return
        self.single = None
        maxlen = max(e[1] for e in entries)
        self.maxlen = maxlen
        size = 1 << maxlen
        self.lens = bytearray(size)
        self.syms = [0] * size
        for sym, length, code in entries:
            rev = 0
            for k in range(length):            # stream-order window bits
                rev |= ((code >> (length - 1 - k)) & 1) << k
            step = 1 << length
            for pos in range(rev, size, step):
                self.lens[pos] = length
                self.syms[pos] = sym

    def decode(self, br):
        if self.single is not None:
            return self.single
        idx = br.peek(self.maxlen)
        length = self.lens[idx]
        if length == 0:
            raise BrotliError("invalid prefix code word")
        br.drop(length)
        return self.syms[idx]


def _canonical(lengths):
    """Canonical code assignment over (length, symbol) order."""
    entries = []
    code = 0
    for bits in range(1, 16):
        for sym, ln in enumerate(lengths):
            if ln == bits:
                entries.append((sym, bits, code))
                code += 1
        code <<= 1
    return entries


def _read_prefix_code(br, alphabet_size):
    hskip = br.read(2)
    if hskip == 1:                             # simple code (§3.4)
        max_bits = (alphabet_size - 1).bit_length()
        nsym = br.read(2) + 1
        syms = []
        for _ in range(nsym):
            v = br.read(max_bits)
            if v >= alphabet_size or v in syms:
                raise BrotliError("bad simple code symbol")
            syms.append(v)
        if nsym == 1:
            return _Code([(syms[0], 0, 0)])
        if nsym == 2:
            a, b = sorted(syms)
            return _Code([(a, 1, 0), (b, 1, 1)])
        if nsym == 3:
            b, c = sorted(syms[1:])
            return _Code([(syms[0], 1, 0), (b, 2, 0b10), (c, 2, 0b11)])
        if br.read(1):                         # [1,2,3,3]
            c, d = sorted(syms[2:])
            return _Code([(syms[0], 1, 0), (syms[1], 2, 0b10),
                          (c, 3, 0b110), (d, 3, 0b111)])
        a, b, c, d = sorted(syms)
        return _Code([(a, 2, 0), (b, 2, 1), (c, 2, 2), (d, 2, 3)])

    # complex code (§3.5): code-length code first
    cl_lens = [0] * 18
    space = 32
    num_codes = 0
    for i in range(hskip, 18):
        idx = br.peek(4)
        br.drop(_CL_PREFIX_LEN[idx])
        v = _CL_PREFIX_VAL[idx]
        cl_lens[_CL_ORDER[i]] = v
        if v:
            space -= 32 >> v
            num_codes += 1
            if space <= 0:
                break
    if num_codes != 1 and space != 0:
        raise BrotliError("code-length code over/under-subscribed")
    if num_codes == 1:
        only = next(s for s, ln in enumerate(cl_lens) if ln)
        cl_code = _Code([(only, 0, 0)])
    else:
        cl_code = _Code(_canonical(cl_lens))

    lengths = [0] * alphabet_size
    symbol = 0
    space = 32768
    prev_len = 8                               # initial repeated length
    repeat = 0
    repeat_len = 0
    while symbol < alphabet_size and space > 0:
        cl = cl_code.decode(br)
        if cl < 16:
            repeat = 0
            lengths[symbol] = cl
            symbol += 1
            if cl:
                prev_len = cl
                space -= 32768 >> cl
        else:
            extra = 2 if cl == 16 else 3
            new_len = prev_len if cl == 16 else 0
            if repeat_len != new_len:
                repeat = 0
                repeat_len = new_len
            old = repeat
            if repeat > 0:
                repeat = (repeat - 2) << extra
            repeat += br.read(extra) + 3
            delta = repeat - old
            if symbol + delta > alphabet_size:
                raise BrotliError("repeat past alphabet")
            for _ in range(delta):
                lengths[symbol] = repeat_len
                symbol += 1
            if repeat_len:
                space -= delta * (32768 >> repeat_len)
    if space != 0:
        raise BrotliError("symbol code over/under-subscribed")
    return _Code(_canonical(lengths))


def _varlen_uint8(br):
    """§9.2 variable-length value in 0..255 (callers add 1)."""
    if br.read(1) == 0:
        return 0
    k = br.read(3)
    if k == 0:
        return 1
    return (1 << k) + br.read(k)


def _context_map(br, size):
    """§7.3: (num trees, context map bytes)."""
    ntrees = _varlen_uint8(br) + 1
    cmap = bytearray(size)
    if ntrees >= 2:
        bits5 = br.peek(5)
        if bits5 & 1:
            rlemax = (bits5 >> 1) + 1
            br.drop(5)
        else:
            rlemax = 0
            br.drop(1)
        code = _read_prefix_code(br, ntrees + rlemax)
        i = 0
        while i < size:
            sym = code.decode(br)
            if sym == 0:
                i += 1                         # cmap[i] already 0
            elif sym <= rlemax:
                reps = (1 << sym) + br.read(sym)
                if i + reps > size:
                    raise BrotliError("context map run overflow")
                i += reps
            else:
                cmap[i] = sym - rlemax
                i += 1
        if br.read(1):                         # inverse move-to-front
            mtf = list(range(256))
            for i in range(size):
                idx = cmap[i]
                v = mtf[idx]
                cmap[i] = v
                if idx:
                    del mtf[idx]
                    mtf.insert(0, v)
    return ntrees, cmap


def _block_len(br, len_code):
    sym = len_code.decode(br)
    return _BLOCK_LEN_BASE[sym] + br.read(_BLOCK_LEN_EXTRA[sym])


def _wbits(br):
    if br.read(1) == 0:
        return 16
    n = br.read(3)
    if n:
        return 17 + n
    n = br.read(3)
    if n == 0:
        return 17
    if n == 1:
        raise BrotliError("reserved WBITS code")
    return 8 + n


def _ferment(w, i):
    """UTF8-aware upper-casing step (appendix B); returns bytes used."""
    c = w[i]
    if c < 0xC0:
        if 97 <= c <= 122:
            w[i] = c ^ 32
        return 1
    if c < 0xE0:
        if i + 1 < len(w):
            w[i + 1] ^= 32
        return 2
    if i + 2 < len(w):
        w[i + 2] ^= 5
    return 3


def _transform_word(word, tid):
    prefix, op, suffix = TRANSFORMS[tid]
    w = bytearray(word)
    if 12 <= op <= 20:                         # omit first 1..9
        w = w[min(op - 11, len(w)):]
    elif 1 <= op <= 9:                         # omit last 1..9
        w = w[:-op] if op < len(w) else bytearray()
    elif op == 10:                             # ferment first
        if w:
            _ferment(w, 0)
    elif op == 11:                             # ferment all
        i = 0
        while i < len(w):
            i += _ferment(w, i)
    return prefix + bytes(w) + suffix


def decompress(data, raw_size: int | None = None) -> bytes:
    """Decode one brotli stream; checks against raw_size if given, and
    raises BrotliError on any corrupt input."""
    try:
        return _decompress(data, raw_size)
    except (IndexError, KeyError, AttributeError, TypeError) as e:
        # a corrupt prefix code, context map or block type indexes past
        # its table
        raise BrotliError(f"corrupt stream: {e!r}") from e


def _decompress(data, raw_size: int | None) -> bytes:
    br = _Bits(data)
    wbits = _wbits(br)
    window = (1 << wbits) - 16
    out = bytearray()
    ddata = None                               # static dictionary, lazy
    ring = [16, 15, 11, 4]                     # §4: persists across
    ridx = 0                                   # meta-blocks

    while True:
        islast = br.read(1)
        if islast and br.read(1):              # ISLASTEMPTY
            break
        nib = br.read(2)
        if nib == 3:                           # metadata meta-block
            if br.read(1):
                raise BrotliError("reserved bit set")
            nbytes = br.read(2)
            skip = 0
            for i in range(nbytes):
                b = br.read(8)
                if i + 1 == nbytes and nbytes > 1 and b == 0:
                    raise BrotliError("exuberant metadata length")
                skip |= b << (8 * i)
            br.align()
            if skip:
                br.read_bytes(skip)
            if islast:
                break
            continue
        mlen = 0
        for i in range(nib + 4):
            b = br.read(4)
            if i + 1 == nib + 4 and nib > 0 and b == 0:
                raise BrotliError("exuberant nibble")
            mlen |= b << (4 * i)
        mlen += 1
        if raw_size is not None and len(out) + mlen > raw_size:
            raise BrotliError(f"meta-block of {mlen} bytes passes the "
                              f"raw size {raw_size}")
        if not islast and br.read(1):          # ISUNCOMPRESSED
            br.align()
            out += br.read_bytes(mlen)
            continue

        # --- meta-block header -------------------------------------
        nbl = [0, 0, 0]
        type_codes = [None, None, None]
        len_codes = [None, None, None]
        blen = [1 << 28] * 3
        btype = [0, 0, 0]
        brb = [[1, 0], [1, 0], [1, 0]]         # [second-to-last, last]
        for c in range(3):
            n = _varlen_uint8(br) + 1
            nbl[c] = n
            if n >= 2:
                type_codes[c] = _read_prefix_code(br, n + 2)
                len_codes[c] = _read_prefix_code(br, 26)
                blen[c] = _block_len(br, len_codes[c])
        npostfix = br.read(2)
        ndirect = br.read(4) << npostfix
        cmodes = [br.read(2) for _ in range(nbl[0])]
        ntreesl, cmap_l = _context_map(br, 64 * nbl[0])
        ntreesd, cmap_d = _context_map(br, 4 * nbl[2])
        lit_codes = [_read_prefix_code(br, 256) for _ in range(ntreesl)]
        cmd_codes = [_read_prefix_code(br, 704) for _ in range(nbl[1])]
        dist_alpha = 16 + ndirect + (48 << npostfix)
        dist_codes = [_read_prefix_code(br, dist_alpha)
                      for _ in range(ntreesd)]

        def switch_block(c):
            sym = type_codes[c].decode(br)
            if sym == 0:
                t = brb[c][0]
            elif sym == 1:
                t = brb[c][1] + 1
            else:
                t = sym - 2
            if t >= nbl[c]:
                t -= nbl[c]
            brb[c][0] = brb[c][1]
            brb[c][1] = t
            btype[c] = t
            blen[c] = _block_len(br, len_codes[c])

        # --- command loop (§9.3) -----------------------------------
        while mlen > 0:
            if blen[1] == 0:
                switch_block(1)
            blen[1] -= 1
            cmd = cmd_codes[btype[1]].decode(br)
            ins_code = _INS_RANGE[cmd >> 6] * 8 + ((cmd >> 3) & 7)
            cpy_code = _CPY_RANGE[cmd >> 6] * 8 + (cmd & 7)
            ilen = _INSERT_BASE[ins_code] + br.read(_INSERT_EXTRA[ins_code])
            clen = _COPY_BASE[cpy_code] + br.read(_COPY_EXTRA[cpy_code])
            implicit = cmd < 128
            if ilen > mlen:
                raise BrotliError("meta-block length overrun")

            mode_off = cmodes[btype[0]] * 512
            for _ in range(ilen):
                if blen[0] == 0:
                    switch_block(0)
                    mode_off = cmodes[btype[0]] * 512
                blen[0] -= 1
                p1 = out[-1] if out else 0
                p2 = out[-2] if len(out) >= 2 else 0
                ctx = CONTEXT_LUT[mode_off + p1] \
                    | CONTEXT_LUT[mode_off + 256 + p2]
                code = lit_codes[cmap_l[(btype[0] << 6) + ctx]]
                out.append(code.decode(br))
            mlen -= ilen
            if mlen <= 0:
                break

            if implicit:
                d = ring[(ridx - 1) & 3]
                push = False
            else:
                if blen[2] == 0:
                    switch_block(2)
                blen[2] -= 1
                dctx = 3 if clen > 4 else clen - 2
                dsym = dist_codes[cmap_d[(btype[2] << 2) + dctx]].decode(br)
                push = dsym != 0
                if dsym < 4:
                    d = ring[(ridx - 1 - dsym) & 3]
                elif dsym < 16:
                    base, delta_idx = ((ridx - 1, dsym - 4) if dsym < 10
                                       else (ridx - 2, dsym - 10))
                    delta = ((0x605142 >> (4 * delta_idx)) & 0xF) - 3
                    d = ring[base & 3] + delta
                    if d <= 0:
                        raise BrotliError("non-positive ring distance")
                elif dsym < 16 + ndirect:
                    d = dsym - 15
                else:
                    x = dsym - ndirect - 16
                    hcode = x >> npostfix
                    lcode = x & ((1 << npostfix) - 1)
                    ndistbits = 1 + (hcode >> 1)
                    offset = ((2 + (hcode & 1)) << ndistbits) - 4
                    d = ((offset + br.read(ndistbits)) << npostfix) \
                        + lcode + ndirect + 1

            maxd = min(len(out), window)
            if d > maxd:                       # static dictionary (§8)
                if not 4 <= clen <= 24 or DICT_NDBITS[clen] == 0:
                    raise BrotliError("bad dictionary copy length")
                if ddata is None:
                    ddata = dictionary()
                word_id = d - maxd - 1
                ndb = DICT_NDBITS[clen]
                tid = word_id >> ndb
                if tid >= len(TRANSFORMS):
                    raise BrotliError("bad transform id")
                woff = DICT_OFFSETS[clen] + (word_id & ((1 << ndb) - 1)) \
                    * clen
                w = _transform_word(ddata[woff:woff + clen], tid)
                if len(w) > mlen:
                    raise BrotliError("meta-block length overrun")
                out += w
                mlen -= len(w)
            else:
                if clen > mlen:
                    raise BrotliError("meta-block length overrun")
                if push:
                    ring[ridx & 3] = d
                    ridx += 1
                if d >= clen:
                    out += out[-d:len(out) - d + clen]
                else:
                    start = len(out) - d
                    for k in range(clen):      # overlapping copy
                        out.append(out[start + k])
                mlen -= clen
        if mlen < 0:
            raise BrotliError("meta-block length overrun")
        if islast:
            break

    if raw_size is not None and len(out) != raw_size:
        raise BrotliError(
            f"decoded {len(out)} bytes, expected {raw_size}")
    return bytes(out)
