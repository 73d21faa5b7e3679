/* LZ4 block-format assembler: serialize a precomputed match list.
 *
 * The device data plane (parallel/device_lz4.py) finds matches with a
 * sort-based parallel scan; this walk emits the byte-level LZ4 block
 * format (literals memcpy'd from src) — O(output) host work, no search.
 * Counterpart of the reference's in-loop serialization inside upstream
 * lz4 (lib/lz4/ vendored; see LZ4_compress_generic).
 *
 * Matches must be sorted by start and reference earlier positions only.
 * Overlapping or out-of-bounds entries are trimmed/skipped, so any match
 * list produces a valid stream (worst case: all literals).
 *
 * Returns the compressed size, or -1 if dst is too small (callers size
 * dst with compress_bound).
 */

#include <stdint.h>
#include <string.h>

#define MINMATCH 4
#define MFLIMIT 12
#define LASTLITERALS 5

static uint8_t *emit_length(uint8_t *op, long len)
{
    long rest = len - 15;
    while (rest >= 255) {
        *op++ = 255;
        rest -= 255;
    }
    *op++ = (uint8_t)rest;
    return op;
}

long lt_lz4_assemble(const uint8_t *src, long n,
                     const int32_t *starts, const int32_t *refs,
                     const int32_t *lens, long m,
                     uint8_t *dst, long cap)
{
    uint8_t *op = dst;
    uint8_t *oend = dst + cap;
    long anchor = 0;
    long limit = n - LASTLITERALS;      /* matches may not cover these */
    long mstart_limit = n - MFLIMIT;    /* last match start rule */

    for (long i = 0; i < m; i++) {
        long s = starts[i], r = refs[i], len = lens[i];
        if (s < anchor) {               /* trim overlap with previous */
            long d = anchor - s;
            s += d;
            r += d;
            len -= d;
        }
        if (len > limit - s)
            len = limit - s;
        if (len < MINMATCH || s >= mstart_limit || r < 0 || r >= s ||
            s - r > 65535)
            continue;

        long lit = s - anchor;
        /* worst-case bytes for this sequence */
        if (op + 1 + lit + lit / 255 + 1 + 2 + 1 + len / 255 + 1 > oend)
            return -1;
        long mcode = len - MINMATCH;
        uint8_t token = (uint8_t)((lit >= 15 ? 15 : lit) << 4 |
                                  (mcode >= 15 ? 15 : mcode));
        *op++ = token;
        if (lit >= 15)
            op = emit_length(op, lit);
        memcpy(op, src + anchor, (size_t)lit);
        op += lit;
        long off = s - r;
        *op++ = (uint8_t)(off & 0xFF);
        *op++ = (uint8_t)(off >> 8);
        if (mcode >= 15)
            op = emit_length(op, mcode);
        anchor = s + len;
    }
    long lit = n - anchor;
    if (op + 1 + lit + lit / 255 + 1 > oend)
        return -1;
    uint8_t token = (uint8_t)((lit >= 15 ? 15 : lit) << 4);
    *op++ = token;
    if (lit >= 15)
        op = emit_length(op, lit);
    memcpy(op, src + anchor, (size_t)lit);
    op += lit;
    return (long)(op - dst);
}
