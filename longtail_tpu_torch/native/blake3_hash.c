/* BLAKE3 64-bit chunk hasher — native host fast path.
 *
 * From the public BLAKE3 spec (IV/permutation/flags are spec constants),
 * bit-exact with ops/blake3.py (KAT-verified).  Only what longtail needs:
 * the 64-bit digest = first 8 output bytes little-endian
 * (lib/blake3/longtail_blake3.c:100).  The batch entry point hashes many
 * chunks of one base buffer per call so ctypes overhead amortizes and the
 * GIL is released for the whole batch.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define CHUNK_START (1u << 0)
#define CHUNK_END   (1u << 1)
#define PARENT      (1u << 2)
#define ROOT        (1u << 3)

static const uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

static const uint8_t PERM[16] = {
    2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8,
};

static inline uint32_t rotr(uint32_t x, int n)
{
    return (x >> n) | (x << (32 - n));
}

static inline void g(uint32_t *v, int a, int b, int c, int d,
                     uint32_t x, uint32_t y)
{
    v[a] = v[a] + v[b] + x;
    v[d] = rotr(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 12);
    v[a] = v[a] + v[b] + y;
    v[d] = rotr(v[d] ^ v[a], 8);
    v[c] = v[c] + v[d];
    v[b] = rotr(v[b] ^ v[c], 7);
}

/* full 16-word output in v; caller reads v[0..7] (cv) or v[0..1] (hash64) */
static void compress(const uint32_t cv[8], const uint32_t block[16],
                     uint64_t counter, uint32_t block_len, uint32_t flags,
                     uint32_t v[16])
{
    uint32_t m[16], t[16];
    int r, i;
    memcpy(m, block, 64);
    memcpy(v, cv, 32);
    v[8] = IV[0]; v[9] = IV[1]; v[10] = IV[2]; v[11] = IV[3];
    v[12] = (uint32_t)counter;
    v[13] = (uint32_t)(counter >> 32);
    v[14] = block_len;
    v[15] = flags;
    for (r = 0; r < 7; r++) {
        g(v, 0, 4, 8, 12, m[0], m[1]);
        g(v, 1, 5, 9, 13, m[2], m[3]);
        g(v, 2, 6, 10, 14, m[4], m[5]);
        g(v, 3, 7, 11, 15, m[6], m[7]);
        g(v, 0, 5, 10, 15, m[8], m[9]);
        g(v, 1, 6, 11, 12, m[10], m[11]);
        g(v, 2, 7, 8, 13, m[12], m[13]);
        g(v, 3, 4, 9, 14, m[14], m[15]);
        if (r < 6) {
            for (i = 0; i < 16; i++)
                t[i] = m[PERM[i]];
            memcpy(m, t, 64);
        }
    }
    for (i = 0; i < 8; i++)
        v[i] ^= v[i + 8];
}

static void load_block(const uint8_t *p, size_t n, uint32_t out[16])
{
    uint8_t buf[64];
    int i;
    memset(buf, 0, 64);
    memcpy(buf, p, n);
    for (i = 0; i < 16; i++)
        out[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8)
               | ((uint32_t)buf[4 * i + 2] << 16)
               | ((uint32_t)buf[4 * i + 3] << 24);
}

/* chunk (<= 1024 bytes) -> chaining value, or root words if root_flags */
static void chunk_out(const uint8_t *data, size_t n, uint64_t counter,
                      uint32_t root, uint32_t out[16])
{
    uint32_t cv[8], block[16];
    size_t off = 0, blen;
    uint32_t flags;
    memcpy(cv, IV, 32);
    do {
        blen = n - off < 64 ? n - off : 64;
        flags = 0;
        if (off == 0)
            flags |= CHUNK_START;
        if (off + blen >= n) {
            flags |= CHUNK_END;
            if (root)
                flags |= ROOT;
        }
        load_block(data + off, blen, block);
        compress(cv, block, counter, (uint32_t)blen, flags, out);
        memcpy(cv, out, 32);
        off += blen;
    } while (off < n);
}

/* non-root subtree chaining value */
static void subtree_cv(const uint8_t *data, size_t n, uint64_t counter,
                       uint32_t cv[8])
{
    uint32_t out[16];
    if (n <= 1024) {
        chunk_out(data, n, counter, 0, out);
    } else {
        size_t p = 1024;
        uint32_t block[16];
        while (p * 2 < n)
            p *= 2;           /* left takes the largest pow2 bytes < n */
        subtree_cv(data, p, counter, block);      /* left cv -> words 0-7 */
        subtree_cv(data + p, n - p, counter + p / 1024, block + 8);
        compress(IV, block, 0, 64, PARENT, out);
    }
    memcpy(cv, out, 32);
}

static uint64_t hash64_one(const uint8_t *data, size_t n)
{
    uint32_t out[16];
    if (n <= 1024) {
        chunk_out(data, n, 0, 1, out);
    } else {
        size_t p = 1024;
        uint32_t block[16];
        while (p * 2 < n)
            p *= 2;
        subtree_cv(data, p, 0, block);
        subtree_cv(data + p, n - p, p / 1024, block + 8);
        compress(IV, block, 0, 64, PARENT | ROOT, out);
    }
    return (uint64_t)out[0] | ((uint64_t)out[1] << 32);
}

void lt_blake3_hash64(const uint8_t *data, long n, uint64_t *out)
{
    *out = hash64_one(data, (size_t)n);
}

/* hash n chunks [offsets[i], offsets[i]+sizes[i]) of base */
void lt_blake3_hash64_batch(const uint8_t *base, const int64_t *offsets,
                            const int64_t *sizes, long n, uint64_t *out)
{
    long i;
    for (i = 0; i < n; i++)
        out[i] = hash64_one(base + offsets[i], (size_t)sizes[i]);
}
