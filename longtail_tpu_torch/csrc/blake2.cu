// BLAKE2s with an 8-byte digest of a batch of chunk rows: each chunk
// chains its 64-byte blocks sequentially; the 64-bit digest is the first
// two output words.
//
// Replaces longtail_tpu/ops/blake2_kernel.py _make_hash_fn.  The TPU
// kernel takes the words transposed, (padded/4, rows), so that chunks
// ride the vector lanes and a block's 16 message words are row slices
// (a Mosaic lane trick).  Here one thread hashes one chunk and reads its
// own row of the row-major (rows, padded/4) input, as the port's BLAKE3
// kernel takes it.
//   Bound on the H100: the chain of dependent compressions of the longest
// chunks (1024 for 64 KiB, 10 rounds of 8 G functions each), since a
// size class of a batch has only hundreds to a few thousand rows, so
// few threads run; and, second, memory access: a thread reading its own
// row makes the warp's loads uncoalesced (32 rows apart), which the
// 16-byte loads only soften.  Launching all classes at once, and staging
// a tile of rows through shared memory in transposed order, are left for
// later.  The message schedule (SIGMA) is
// resolved at compile time, so the 16 message words stay in registers.
// Only the chunk's own blocks run: t = min(64 (k + 1), length), the last
// block sets the final flag, and a zero-length row hashes one zero block.
//
// Input words must be zero past each row's length (the pack kernel
// guarantees it); the row length in words must be a multiple of 16.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef LT_BLAKE2_IV0
#error "build through longtail_tpu_torch/_kernels.py, which defines the algorithm constants"
#endif

namespace {

constexpr int kBlockBytes = LT_BLAKE2_BLOCK_BYTES;
constexpr int kBlockWords = kBlockBytes / 4;
constexpr uint32_t kParam0 = LT_BLAKE2_PARAM0;
constexpr int kThreads = 128;

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

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d, uint32_t x, uint32_t y) {
  a = a + b + x;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 12);
  a = a + b + y;
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
blake2_kernel(const uint32_t* __restrict__ words,
              const int32_t* __restrict__ lengths, uint32_t* __restrict__ out,
              int rows, int row_words) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int len = lengths[row];
  const int n_blocks = max((len + kBlockBytes - 1) / kBlockBytes, 1);
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = iv(i);
  h[0] ^= kParam0;
  const uint4* src =
      reinterpret_cast<const uint4*>(words + (long long)row * row_words);
  for (int k = 0; k < n_blocks; ++k) {
    uint32_t m[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 w = src[4 * k + q];
      m[4 * q] = w.x;
      m[4 * q + 1] = w.y;
      m[4 * q + 2] = w.z;
      m[4 * q + 3] = w.w;
    }
    const uint32_t t = (uint32_t)min((k + 1) * kBlockBytes, len);
    compress(h, m, t, k == n_blocks - 1);
  }
  out[row] = h[0];
  out[rows + row] = h[1];
}

}  // namespace

// words (rows, row_words) u32, lengths (rows,) i32 -> out (2, rows) u32:
// row 0 = digest word 0 (lo), row 1 = word 1 (hi)
extern "C" int lt_blake2(const void* words, const void* lengths, void* out,
                         int rows, int row_words, void* stream) {
  static_assert(kBlockWords == 16, "BLAKE2s blocks are 16 words");
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  blake2_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths, (uint32_t*)out, rows,
      row_words);
  return (int)cudaGetLastError();
}
