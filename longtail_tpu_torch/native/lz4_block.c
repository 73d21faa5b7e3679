/* LZ4 block-format codec, written from the public format specification
 * (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md).
 *
 * Role: host-side fast path for the compress-block-store (the reference
 * wraps upstream lz4, lib/lz4/longtail_lz4.c; this is an independent
 * implementation of the same interchange format).  A greedy single-pass
 * hash-table matcher, compatible with any spec-conforming decoder.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define MINMATCH      4
#define MFLIMIT       12  /* matches must not start within the last 12 bytes */
#define LASTLITERALS  5   /* the last 5 bytes are always literals */
#define MAX_DISTANCE  65535

#define HASH_LOG  16
#define HASH_SIZE (1u << HASH_LOG)

static uint32_t rd32(const uint8_t *p) { uint32_t v; memcpy(&v, p, 4); return v; }

static uint32_t hash4(const uint8_t *p)
{
    return (rd32(p) * 2654435761u) >> (32 - HASH_LOG);
}

size_t lt_lz4_compress_bound(size_t n)
{
    return n + n / 255 + 16;
}

/* Returns compressed size, or -1 on overflow/error. */
long lt_lz4_compress(const uint8_t *src, size_t src_len,
                     uint8_t *dst, size_t dst_cap)
{
    static const size_t SKIP_TRIGGER = 6; /* acceleration like upstream */
    uint32_t table[HASH_SIZE];
    const uint8_t *ip = src, *anchor = src;
    const uint8_t *iend = src + src_len;
    const uint8_t *match_limit = (src_len >= MFLIMIT) ? iend - MFLIMIT : src;
    uint8_t *op = dst, *oend = dst + dst_cap;

    if (src_len > 0x7E000000u) return -1;
    memset(table, 0, sizeof table);

    if (src_len >= MINMATCH + LASTLITERALS) {
        size_t search_count = 0;
        ip = src;
        while (ip < match_limit) {
            /* find a match candidate */
            const uint8_t *match = NULL;
            uint32_t h = hash4(ip);
            uint32_t cand = table[h];
            table[h] = (uint32_t)(ip - src) + 1;
            if (cand != 0) {
                const uint8_t *cp = src + cand - 1;
                if ((size_t)(ip - cp) <= MAX_DISTANCE && rd32(cp) == rd32(ip))
                    match = cp;
            }
            if (!match) {
                ip += 1 + (search_count++ >> SKIP_TRIGGER);
                continue;
            }
            search_count = 0;

            /* extend backwards */
            while (ip > anchor && match > src && ip[-1] == match[-1]) {
                --ip; --match;
            }

            /* extend forwards (bounded so the last 5 bytes stay literal) */
            {
                const uint8_t *fwd_limit = iend - LASTLITERALS;
                const uint8_t *mp = match + MINMATCH;
                const uint8_t *p = ip + MINMATCH;
                while (p < fwd_limit && *p == *mp) { ++p; ++mp; }

                size_t lit_len = (size_t)(ip - anchor);
                size_t match_len = (size_t)(p - ip);
                size_t mlen_code = match_len - MINMATCH;
                uint16_t offset = (uint16_t)(ip - match);

                /* worst-case sequence size check */
                if (op + 1 + lit_len + lit_len / 255 + 2 + 1 + mlen_code / 255 + 8 > oend)
                    return -1;

                /* token */
                uint8_t *token = op++;
                if (lit_len >= 15) {
                    size_t l = lit_len - 15;
                    *token = (uint8_t)(15 << 4);
                    while (l >= 255) { *op++ = 255; l -= 255; }
                    *op++ = (uint8_t)l;
                } else {
                    *token = (uint8_t)(lit_len << 4);
                }
                memcpy(op, anchor, lit_len);
                op += lit_len;

                /* offset */
                *op++ = (uint8_t)offset;
                *op++ = (uint8_t)(offset >> 8);

                /* match length */
                if (mlen_code >= 15) {
                    size_t l = mlen_code - 15;
                    *token |= 15;
                    while (l >= 255) { *op++ = 255; l -= 255; }
                    *op++ = (uint8_t)l;
                } else {
                    *token |= (uint8_t)mlen_code;
                }

                ip = p;
                anchor = ip;
                /* prime the table at the end of the match for future hits */
                if (ip < match_limit) {
                    table[hash4(ip - 2)] = (uint32_t)(ip - 2 - src) + 1;
                }
            }
        }
    }

    /* trailing literals */
    {
        size_t lit_len = (size_t)(iend - anchor);
        if (op + 1 + lit_len + lit_len / 255 + 1 > oend) return -1;
        if (lit_len >= 15) {
            size_t l = lit_len - 15;
            *op++ = (uint8_t)(15 << 4);
            while (l >= 255) { *op++ = 255; l -= 255; }
            *op++ = (uint8_t)l;
        } else {
            *op++ = (uint8_t)(lit_len << 4);
        }
        memcpy(op, anchor, lit_len);
        op += lit_len;
    }
    return (long)(op - dst);
}

/* Returns decompressed size, or -1 on malformed input. */
long lt_lz4_decompress(const uint8_t *src, size_t src_len,
                       uint8_t *dst, size_t dst_cap)
{
    const uint8_t *ip = src, *iend = src + src_len;
    uint8_t *op = dst, *oend = dst + dst_cap;

    while (ip < iend) {
        uint8_t token = *ip++;
        /* literals */
        size_t lit_len = token >> 4;
        if (lit_len == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit_len += b;
            } while (b == 255);
        }
        if ((size_t)(iend - ip) < lit_len || (size_t)(oend - op) < lit_len)
            return -1;
        memcpy(op, ip, lit_len);
        ip += lit_len;
        op += lit_len;
        if (ip >= iend) break;  /* last sequence has no match part */

        /* match */
        if (iend - ip < 2) return -1;
        size_t offset = (size_t)ip[0] | ((size_t)ip[1] << 8);
        ip += 2;
        if (offset == 0 || (size_t)(op - dst) < offset) return -1;
        size_t match_len = (token & 15) + MINMATCH;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                match_len += b;
            } while (b == 255);
        }
        if ((size_t)(oend - op) < match_len) return -1;
        {   /* overlapping copy must run byte-forward */
            const uint8_t *mp = op - offset;
            size_t n = match_len;
            while (n--) *op++ = *mp++;
        }
    }
    return (long)(op - dst);
}
