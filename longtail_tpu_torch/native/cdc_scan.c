/* HPCDC content-defined chunk scanner — native host fast path.
 *
 * Bit-exact with ops/cdc.py::chunk_part (itself golden-verified against the
 * reference chunker fixtures, lib/hpcdcchunker/longtail_hpcdcchunker.c).
 * One call scans one file part sequentially with the rolling recurrence
 * h' = rotl(h,1) ^ rotl(T[outgoing],16) ^ T[incoming] and emits chunk end
 * offsets under the min/avg/max constraints.  The byte-to-word table is the
 * published HPCDC algorithm constant (longtail_hpcdcchunker.c:23-88).
 *
 * The Python numpy path remains as oracle and fallback; ctypes releases the
 * GIL for the call, so per-asset worker threads scan in true parallel.
 */

#include <stdint.h>
#include <stddef.h>

static const uint32_t T[256] = {
    0x458be752u, 0xc10748ccu, 0xfbbcdbb8u, 0x6ded5b68u, 0xb10a82b5u, 0x20d75648u,
    0xdfc5665fu, 0xa8428801u, 0x7ebf5191u, 0x841135c7u, 0x65cc53b3u, 0x280a597cu,
    0x16f60255u, 0xc78cbc3eu, 0x294415f5u, 0xb938d494u, 0xec85c4e6u, 0xb7d33edcu,
    0xe549b544u, 0xfdeda5aau, 0x882bf287u, 0x3116737cu, 0x05569956u, 0xe8cc1f68u,
    0x0806ac5eu, 0x22a14443u, 0x15297e10u, 0x50d090e7u, 0x4ba60f6fu, 0xefd9f1a7u,
    0x5c5c885cu, 0x82482f93u, 0x9bfd7c64u, 0x0b3e7276u, 0xf2688e77u, 0x8fad8abcu,
    0xb0509568u, 0xf1ada29fu, 0xa53efdfeu, 0xcb2b1d00u, 0xf2a9e986u, 0x6463432bu,
    0x95094051u, 0x5a223ad2u, 0x9be8401bu, 0x61e579cbu, 0x1a556a14u, 0x5840fdc2u,
    0x9261ddf6u, 0xcde002bbu, 0x52432bb0u, 0xbf17373eu, 0x7b7c222fu, 0x2955ed16u,
    0x9f10ca59u, 0xe840c4c9u, 0xccabd806u, 0x14543f34u, 0x1462417au, 0x0d4a1f9cu,
    0x087ed925u, 0xd7f8f24cu, 0x7338c425u, 0xcf86c8f5u, 0xb19165cdu, 0x9891c393u,
    0x325384acu, 0x0308459du, 0x86141d7eu, 0xc922116au, 0xe2ffa6b6u, 0x53f52aedu,
    0x2cd86197u, 0xf5b9f498u, 0xbf319c8fu, 0xe0411faeu, 0x977eb18cu, 0xd8770976u,
    0x9833466au, 0xc674df7fu, 0x8c297d45u, 0x8ca48d26u, 0xc49ed8e2u, 0x7344f874u,
    0x556f79c7u, 0x6b25eaedu, 0xa03e2b42u, 0xf68f66a4u, 0x8e8b09a2u, 0xf2e0e62au,
    0x0d3a9806u, 0x9729e493u, 0x8c72b0fcu, 0x160b94f6u, 0x450e4d3du, 0x7a320e85u,
    0xbef8f0e1u, 0x21d73653u, 0x4e3d977au, 0x1e7b3929u, 0x1cc6c719u, 0xbe478d53u,
    0x8d752809u, 0xe6d8c2c6u, 0x275f0892u, 0xc8acc273u, 0x4cc21580u, 0xecc4a617u,
    0xf5f7be70u, 0xe795248au, 0x375a2fe9u, 0x425570b6u, 0x8898dcf8u, 0xdc2d97c4u,
    0x0106114bu, 0x364dc22fu, 0x1e0cad1fu, 0xbe63803cu, 0x5f69fac2u, 0x4d5afa6fu,
    0x1bc0dfb5u, 0xfb273589u, 0x0ea47f7bu, 0x3c1c2b50u, 0x21b2a932u, 0x6b1223fdu,
    0x2fe706a8u, 0xf9bd6ce2u, 0xa268e64eu, 0xe987f486u, 0x3eacf563u, 0x1ca2018cu,
    0x65e18228u, 0x2207360au, 0x57cf1715u, 0x34c37d2bu, 0x1f8f3cdeu, 0x93b657cfu,
    0x31a019fdu, 0xe69eb729u, 0x8bca7b9bu, 0x4c9d5bedu, 0x277ebeafu, 0xe0d8f8aeu,
    0xd150821cu, 0x31381871u, 0xafc3f1b0u, 0x927db328u, 0xe95effacu, 0x305a47bdu,
    0x426ba35bu, 0x1233af3fu, 0x686a5b83u, 0x50e072e5u, 0xd9d3bb2au, 0x8befc475u,
    0x487f0de6u, 0xc88dff89u, 0xbd664d5eu, 0x971b5d18u, 0x63b14847u, 0xd7d3c1ceu,
    0x7f583cf3u, 0x72cbcb09u, 0xc0d0a81cu, 0x7fa3429bu, 0xe9158a1bu, 0x225ea19au,
    0xd8ca9ea3u, 0xc763b282u, 0xbb0c6341u, 0x020b8293u, 0xd4cd299du, 0x58cfa7f8u,
    0x91b4ee53u, 0x37e4d140u, 0x95ec764cu, 0x30f76b06u, 0x5ee68d24u, 0x679c8661u,
    0xa41979c2u, 0xf2b61284u, 0x4fac1475u, 0x0adb49f9u, 0x19727a23u, 0x15a7e374u,
    0xc43a18d5u, 0x3fb1aa73u, 0x342fc615u, 0x924c0793u, 0xbee2d7f0u, 0x8a279de9u,
    0x4aa2d70cu, 0xe24dd37fu, 0xbe862c0bu, 0x177c22c2u, 0x5388e5eeu, 0xcd8a7510u,
    0xf901b4fdu, 0xdbc13dbcu, 0x6c0bae5bu, 0x64efe8c7u, 0x48b02079u, 0x80331a49u,
    0xca3d8ae6u, 0xf3546190u, 0xfed7108bu, 0xc49b941bu, 0x32baf4a9u, 0xeb833a4au,
    0x88a3f1a5u, 0x3a91ce0au, 0x3cc27da1u, 0x7112e684u, 0x4a3096b1u, 0x3794574cu,
    0xa3c8b6f3u, 0x1d213941u, 0x6e0a2e00u, 0x233479f1u, 0x0f4cd82fu, 0x6093edd2u,
    0x5d7d209eu, 0x464fe319u, 0xd4dcac9eu, 0x0db845cbu, 0xfb5e4bc3u, 0xe0256ce1u,
    0x09fb4ed1u, 0x0914be1eu, 0xa5bdb2c3u, 0xc6eb57bbu, 0x30320350u, 0x3f397e91u,
    0xa67791bcu, 0x86bc0e2cu, 0xefa0a7e2u, 0xe9ff7543u, 0xe733612cu, 0xd185897bu,
    0x329e5388u, 0x91dd236bu, 0x2ecb0d93u, 0xf4d82a3du, 0x35b5c03fu, 0xe4e606f0u,
    0x05b21843u, 0x37b45964u, 0x5eff22f4u, 0x6027f4ccu, 0x77178b3cu, 0xae507131u,
    0x7bf7cabcu, 0xf9c18d66u, 0x593ade65u, 0xd95ddf11u
};

static inline uint32_t rotl(uint32_t x, int r)
{
    r &= 31;
    return r ? (x << r) | (x >> (32 - r)) : x;
}

/* Scan data[0..n) into chunks; writes end offsets (exclusive) to ends.
 * Returns the chunk count, or -1 if ends_cap would overflow.
 * Requires min_size >= 48 (the window) — the caller guarantees it. */
long lt_cdc_chunk(const uint8_t *data, long n, long min_size, long max_size,
                  uint32_t d, long *ends, long ends_cap)
{
    long s = 0, cnt = 0;
    if (n <= 0)
        return 0;
    while (s < n) {
        long left = n - s;
        long pos, data_len;
        uint32_t h = 0;
        int i;
        if (cnt >= ends_cap)
            return -1;
        if (left <= min_size) {
            ends[cnt++] = n;
            break;
        }
        for (i = 0; i < 48; i++)
            h ^= rotl(T[data[s + min_size - 48 + i]], (48 - i - 1) & 31);
        pos = min_size;
        data_len = left < max_size ? left : max_size;
        while (pos < data_len) {
            uint8_t incoming = data[s + pos];
            uint8_t outgoing = data[s + pos - 48];
            h = rotl(h, 1) ^ rotl(T[outgoing], 16) ^ T[incoming];
            pos++;
            if (h % d == d - 1)
                break;
        }
        ends[cnt++] = s + pos;
        s += pos;
    }
    return cnt;
}
