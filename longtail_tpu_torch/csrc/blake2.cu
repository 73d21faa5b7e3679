// BLAKE2s with an 8-byte digest of chunks where they lie in a flat byte
// batch: each chunk chains its 64-byte blocks; the 64-bit digest is the
// first two output words.
//
// Replaces longtail_tpu/ops/blake2_kernel.py _make_hash_fn and, on this
// path, the pack kernel in front of it.  The TPU kernel takes packed rows
// transposed, (padded/4, rows), one launch per power-of-two size class,
// so that chunks ride the vector lanes and a block's 16 message words are
// row slices (a Mosaic lane trick); pack first copies every chunk into
// its class's aligned, zero-padded rows.  Here every chunk of a batch is
// hashed in one launch, read once where it lies.
//   What holds it back, by a model of this one-thread-per-chunk design
// (an estimate, not a measured bound): the chain.  A chunk's
// compressions depend on one another, and a compression is 968 integer
// instructions (10 rounds of 8 G functions of 12, and 8 output xors)
// whose only parallelism is the four G functions of a half-round.  If a
// sub-partition of an SM runs a warp's 32-bit integer instruction on its
// 16 INT32 lanes, one warp alone issues at most one every other cycle,
// and a 64 KiB chunk's 1024 compressions take ~1024 x 968 x 2 / 1.98 GHz
// ~ 1.0 ms.  The operations bound of a 64 MiB batch (~0.06 ms) assumes
// every lane busy; its ~4,850 chunks make only ~150 warps for the card's
// 528 sub-partitions, and the longest chains set the time.  Splitting a
// compression across lanes does not shorten the chain; it adds shuffle
// latency to it.
// Design:
//  - One thread per chunk.  Threads take chunks in the host's order
//    (ops/blake2.py plan_order: descending block count), so a warp's 32
//    chains have nearly equal lengths and the longest start in the first
//    wave; blocks are one warp, so the longest warps spread over the SMs'
//    schedulers instead of sharing them.
//  - A block's 16 message words come from the batch at any byte offset
//    (chunk_bytes.cuh: aligned 16-byte loads and a funnel shift per word,
//    bytes past the chunk zeroed in registers), the next block's loads in
//    flight while the current one compresses.
//  - SIGMA is resolved at compile time, so m[] stays in registers.
//  - The digest is written at the chunk's own index: chunk order.
// Only the chunk's own blocks run: t = min(64 (k + 1), size), the last
// block sets the final flag, and a chunk of size 0 hashes one zero block.
// The kernel traps on an order entry or a chunk outside the batch.

#include <cstdint>
#include <cuda_runtime.h>

#include "chunk_bytes.cuh"

#ifndef LT_BLAKE2_IV0
#error "build through longtail_tpu_torch/_kernels.py, which defines the algorithm constants"
#endif

namespace {

using chunk_bytes::fetch_block;
using chunk_bytes::load_block;

constexpr int kBlockBytes = LT_BLAKE2_BLOCK_BYTES;
constexpr uint32_t kParam0 = LT_BLAKE2_PARAM0;
constexpr int kThreads = 32;                // one warp a block
static_assert(kBlockBytes == chunk_bytes::kBlockBytes,
              "BLAKE2s blocks are 16 words");

__host__ __device__ constexpr uint32_t iv(int i) {
  constexpr uint32_t v[8] = {LT_BLAKE2_IV0, LT_BLAKE2_IV1, LT_BLAKE2_IV2,
                             LT_BLAKE2_IV3, LT_BLAKE2_IV4, LT_BLAKE2_IV5,
                             LT_BLAKE2_IV6, LT_BLAKE2_IV7};
  return v[i];
}

// message word used at slot i of round r; each round's permutation
// arrives as one macro of 16 packed 4-bit indices, slot 0 lowest
__host__ __device__ constexpr int sigma(int r, int i) {
  constexpr unsigned long long s[10] = {
      LT_BLAKE2_SIGMA0, LT_BLAKE2_SIGMA1, LT_BLAKE2_SIGMA2, LT_BLAKE2_SIGMA3,
      LT_BLAKE2_SIGMA4, LT_BLAKE2_SIGMA5, LT_BLAKE2_SIGMA6, LT_BLAKE2_SIGMA7,
      LT_BLAKE2_SIGMA8, LT_BLAKE2_SIGMA9};
  return (int)((s[r] >> (4 * i)) & 15ull);
}

// a compile-time constant, so that m[] stays in registers
template <int R, int I>
struct Sigma {
  static constexpr int value = sigma(R, I);
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// a + x is off the chain through b
__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d, uint32_t x, uint32_t y) {
  a = a + x + b;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 12);
  a = a + y + b;
  d = rotr(d ^ a, 8);
  c = c + d;
  b = rotr(b ^ c, 7);
}

template <int R>
__device__ __forceinline__ void round_fn(uint32_t v[16], const uint32_t m[16]) {
  g(v[0], v[4], v[8], v[12], m[Sigma<R, 0>::value], m[Sigma<R, 1>::value]);
  g(v[1], v[5], v[9], v[13], m[Sigma<R, 2>::value], m[Sigma<R, 3>::value]);
  g(v[2], v[6], v[10], v[14], m[Sigma<R, 4>::value], m[Sigma<R, 5>::value]);
  g(v[3], v[7], v[11], v[15], m[Sigma<R, 6>::value], m[Sigma<R, 7>::value]);
  g(v[0], v[5], v[10], v[15], m[Sigma<R, 8>::value], m[Sigma<R, 9>::value]);
  g(v[1], v[6], v[11], v[12], m[Sigma<R, 10>::value], m[Sigma<R, 11>::value]);
  g(v[2], v[7], v[8], v[13], m[Sigma<R, 12>::value], m[Sigma<R, 13>::value]);
  g(v[3], v[4], v[9], v[14], m[Sigma<R, 14>::value], m[Sigma<R, 15>::value]);
}

// h <- compress(h, m, t, final), t < 2**32 (t_hi = 0)
__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint32_t t, bool final) {
  uint32_t v[16] = {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
                    iv(0), iv(1), iv(2), iv(3),
                    iv(4) ^ t, iv(5), final ? ~iv(6) : iv(6), iv(7)};
  round_fn<0>(v, m);
  round_fn<1>(v, m);
  round_fn<2>(v, m);
  round_fn<3>(v, m);
  round_fn<4>(v, m);
  round_fn<5>(v, m);
  round_fn<6>(v, m);
  round_fn<7>(v, m);
  round_fn<8>(v, m);
  round_fn<9>(v, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

__global__ void __launch_bounds__(kThreads)
blake2_kernel(const uint8_t* __restrict__ bytes,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ sizes,
              const int32_t* __restrict__ order, uint32_t* __restrict__ out,
              int n_chunks, long long n_bytes) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_chunks) return;
  const int c = order[t];
  if (c < 0 || c >= n_chunks) __trap();     // not an index of a chunk
  const int size = sizes[c];
  const long long a = starts[c];
  if (a < 0 || size < 0 || a + size > n_bytes) __trap();  // outside the batch
  const int n_blocks = max((size + kBlockBytes - 1) / kBlockBytes, 1);
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = iv(i);
  h[0] ^= kParam0;
  // the next block's loads are in flight during this one's compression
  uint4 q[5];
  fetch_block(bytes, a, min(size, kBlockBytes), q);
  for (int k = 0; k < n_blocks; ++k) {
    const int blen = min(size - k * kBlockBytes, kBlockBytes);
    uint32_t m[16];
    load_block(q, a + (long long)k * kBlockBytes, blen, m);
    if (k + 1 < n_blocks) {
      fetch_block(bytes, a + (long long)(k + 1) * kBlockBytes,
                  min(size - (k + 1) * kBlockBytes, kBlockBytes), q);
    }
    compress(h, m, (uint32_t)min((k + 1) * kBlockBytes, size),
             k == n_blocks - 1);
  }
  out[c] = h[0];
  out[n_chunks + c] = h[1];
}

}  // namespace

// bytes (n_bytes,) u8, starts, sizes (n_chunks,) i32, order a permutation
// of the chunks (plan_order) -> out (2, n_chunks) u32: row 0 = digest
// word 0 (lo), row 1 = word 1 (hi), in chunk order
extern "C" int lt_blake2(const void* bytes, long long n_bytes,
                         const void* starts, const void* sizes,
                         const void* order, void* out, int n_chunks,
                         void* stream) {
  if (n_chunks > 0) {
    const unsigned blocks = (unsigned)((n_chunks + kThreads - 1) / kThreads);
    blake2_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bytes, (const int32_t*)starts, (const int32_t*)sizes,
        (const int32_t*)order, (uint32_t*)out, n_chunks, n_bytes);
  }
  return (int)cudaGetLastError();
}
