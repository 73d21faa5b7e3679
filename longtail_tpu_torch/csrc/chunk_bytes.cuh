// Message blocks of a chunk read where it lies in a flat byte batch: the
// loads shared by the BLAKE3 and BLAKE2 batch kernels.
//
// A 64-byte block at any byte offset a is five 16-byte loads aligned down
// to a & ~15, then one funnel shift per word; bytes at or past the
// chunk's end are zeroed in registers (what pack's zero padding gave the
// row kernels).  fetch_block issues the loads and load_block assembles
// the words, so a caller can put the next block's loads in flight before
// it compresses the current one.  No load reaches past the chunk's last
// byte rounded up to 16, so none past a batch of whole 16-byte words.
//   LT_VARIANT_NO_LOADS (a timing build of blake3.cu only) makes the
// bytes in registers instead of loading them.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace chunk_bytes {

constexpr int kBlockBytes = 64;

// m[i] = little-endian word at byte 4 i + 4 Q + sh / 8 of w
template <int Q>
__device__ __forceinline__ void shift_words(const uint32_t w[20], int sh,
                                            uint32_t m[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = __funnelshift_r(w[Q + i], w[Q + i + 1], sh);
}

// the five aligned 16-byte loads that cover the blen (0..64) bytes at a,
// none past the chunk's last byte (so none past the batch)
__device__ __forceinline__ void fetch_block(const uint8_t* __restrict__ bytes,
                                            long long a, int blen,
                                            uint4 q[5]) {
  const long long a0 = a & ~15LL;
  const uint4* src = reinterpret_cast<const uint4*>(bytes + a0);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#ifdef LT_VARIANT_NO_LOADS
    q[k] = a0 + 16 * k < a + blen
               ? make_uint4((uint32_t)a0 + k, (uint32_t)a * 3u, (uint32_t)k,
                            (uint32_t)blen)
               : make_uint4(0u, 0u, 0u, 0u);
#else
    q[k] = a0 + 16 * k < a + blen ? __ldg(src + k)
                                  : make_uint4(0u, 0u, 0u, 0u);
#endif
  }
}

// m = the blen bytes at a from fetch_block's loads, zero past them
__device__ __forceinline__ void load_block(const uint4 q[5], long long a,
                                           int blen, uint32_t m[16]) {
  uint32_t w[20];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    w[4 * k] = q[k].x;
    w[4 * k + 1] = q[k].y;
    w[4 * k + 2] = q[k].z;
    w[4 * k + 3] = q[k].w;
  }
  const int lead = (int)(a & 15), sh = 8 * (lead & 3);
  switch (lead >> 2) {
    case 0: shift_words<0>(w, sh, m); break;
    case 1: shift_words<1>(w, sh, m); break;
    case 2: shift_words<2>(w, sh, m); break;
    default: shift_words<3>(w, sh, m); break;
  }
  if (blen < kBlockBytes) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int nb = blen - 4 * i;          // chunk bytes in word i
      m[i] = nb >= 4 ? m[i] : nb <= 0 ? 0u : m[i] & ((1u << (8 * nb)) - 1u);
    }
  }
}

}  // namespace chunk_bytes
