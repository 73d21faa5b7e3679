// BLAKE3-64 of a batch of chunk rows: the 16 compressions of every 1 KiB
// leaf, then the left-leaning tree merge of each chunk's leaves.  The
// 64-bit digest is the first two output words.
//
// Replaces longtail_tpu/ops/blake3_kernel.py _make_hash_fn (its
// `_hash_kernel` / `_hash_tile`, entry hash_chunks_words_device).  The TPU
// kernel lays leaves out as lanes of a transposed (256, L) word array so
// that a block's 16 message words are row slices; a GPU thread reads its
// leaf's contiguous words directly, so the row-major (rows, padded/4)
// input needs no transpose.
//   Bound on the H100: integer ALU work (112 G-function rounds of ~14
// operations per 64-byte block), not bandwidth.  Design: one thread per
// leaf, a block holding max(64, leaves per row) threads and so one or
// more whole rows; each thread keeps the 16-word state and 16 message
// words in registers for its leaf's compressions (the message schedule is
// resolved at compile time), skipping leaves and blocks past the chunk's
// length.  The leaf chaining values then merge level by level in shared
// memory: adjacent pairs compress with PARENT (ROOT on the last merge) and
// an odd tail carries up, as blake3_kernel.py does within its tile.  A
// row of length 0 hashes the empty input.
//
// Input words must be zero past each row's length (the pack kernel
// guarantees it); leaves per row must be a power of two <= 1024.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef LT_BLAKE3_IV0
#error "build through longtail_tpu_torch/_kernels.py, which defines the algorithm constants"
#endif

namespace {

constexpr uint32_t kChunkStart = LT_BLAKE3_CHUNK_START;
constexpr uint32_t kChunkEnd = LT_BLAKE3_CHUNK_END;
constexpr uint32_t kParent = LT_BLAKE3_PARENT;
constexpr uint32_t kRoot = LT_BLAKE3_ROOT;
constexpr int kBlockBytes = LT_BLAKE3_BLOCK_BYTES;
constexpr int kLeafBytes = LT_BLAKE3_LEAF_BYTES;
constexpr int kLeafWords = kLeafBytes / 4;

__host__ __device__ constexpr uint32_t iv(int i) {
  constexpr uint32_t v[8] = {LT_BLAKE3_IV0, LT_BLAKE3_IV1, LT_BLAKE3_IV2,
                             LT_BLAKE3_IV3, LT_BLAKE3_IV4, LT_BLAKE3_IV5,
                             LT_BLAKE3_IV6, LT_BLAKE3_IV7};
  return v[i];
}

// message word used at slot i of round r: PERM applied r times
__host__ __device__ constexpr int sched(int r, int i) {
  constexpr int perm[16] = {
      LT_BLAKE3_PERM0,  LT_BLAKE3_PERM1,  LT_BLAKE3_PERM2,  LT_BLAKE3_PERM3,
      LT_BLAKE3_PERM4,  LT_BLAKE3_PERM5,  LT_BLAKE3_PERM6,  LT_BLAKE3_PERM7,
      LT_BLAKE3_PERM8,  LT_BLAKE3_PERM9,  LT_BLAKE3_PERM10, LT_BLAKE3_PERM11,
      LT_BLAKE3_PERM12, LT_BLAKE3_PERM13, LT_BLAKE3_PERM14, LT_BLAKE3_PERM15};
  for (int k = 0; k < r; ++k) i = perm[i];
  return i;
}

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

// a compile-time constant, so that m[] stays in registers
template <int R, int I>
struct Sched {
  static constexpr int value = sched(R, I);
};

template <int R>
__device__ __forceinline__ void round_fn(uint32_t v[16], const uint32_t m[16]) {
  g(v[0], v[4], v[8], v[12], m[Sched<R, 0>::value], m[Sched<R, 1>::value]);
  g(v[1], v[5], v[9], v[13], m[Sched<R, 2>::value], m[Sched<R, 3>::value]);
  g(v[2], v[6], v[10], v[14], m[Sched<R, 4>::value], m[Sched<R, 5>::value]);
  g(v[3], v[7], v[11], v[15], m[Sched<R, 6>::value], m[Sched<R, 7>::value]);
  g(v[0], v[5], v[10], v[15], m[Sched<R, 8>::value], m[Sched<R, 9>::value]);
  g(v[1], v[6], v[11], v[12], m[Sched<R, 10>::value], m[Sched<R, 11>::value]);
  g(v[2], v[7], v[8], v[13], m[Sched<R, 12>::value], m[Sched<R, 13>::value]);
  g(v[3], v[4], v[9], v[14], m[Sched<R, 14>::value], m[Sched<R, 15>::value]);
}

// cv <- first 8 output words of compress(cv, m, counter, len, flags)
__device__ __forceinline__ void compress(uint32_t cv[8], const uint32_t m[16],
                                         uint32_t counter, uint32_t len,
                                         uint32_t flags) {
  uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    iv(0), iv(1), iv(2), iv(3), counter, 0u, len, flags};
  round_fn<0>(v, m);
  round_fn<1>(v, m);
  round_fn<2>(v, m);
  round_fn<3>(v, m);
  round_fn<4>(v, m);
  round_fn<5>(v, m);
  round_fn<6>(v, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

template <int T>
__global__ void __launch_bounds__(T)
blake3_kernel(const uint32_t* __restrict__ words,
              const int32_t* __restrict__ lengths, uint32_t* __restrict__ out,
              int rows, int row_words) {
  __shared__ uint32_t cvs[T][8];
  const int leaves = row_words / kLeafWords;    // power of two, <= T
  const int t = threadIdx.x;
  const int row = blockIdx.x * (T / leaves) + t / leaves;
  const int leaf = t & (leaves - 1);
  const bool live = row < rows;
  const int len = live ? lengths[row] : 0;
  const int n_leaves = max((len + kLeafBytes - 1) / kLeafBytes, 1);

  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = iv(i);
  if (live && leaf < n_leaves) {
    const int leaf_len = min(max(len - leaf * kLeafBytes, 0), kLeafBytes);
    const int n_blocks = max((leaf_len + kBlockBytes - 1) / kBlockBytes, 1);
    const uint4* src = reinterpret_cast<const uint4*>(
        words + (long long)row * row_words + (long long)leaf * kLeafWords);
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
      const bool last = k == n_blocks - 1;
      const uint32_t flags = (k == 0 ? kChunkStart : 0u) |
                             (last ? kChunkEnd : 0u) |
                             (last && n_leaves == 1 ? kRoot : 0u);
      const int blen = min(leaf_len - k * kBlockBytes, kBlockBytes);
      compress(h, m, (uint32_t)leaf, (uint32_t)blen, flags);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cvs[t][i] = h[i];
  __syncthreads();

  // level `step`: live node i of a chunk sits at leaf i * step; node pairs
  // (2j, 2j+1) merge into the left one, a node without partner carries up
  for (int step = 1; step < leaves; step <<= 1) {
    const int nodes = (n_leaves + step - 1) / step;
    const bool merge = live && (leaf & (2 * step - 1)) == 0 &&
                       leaf / step + 1 < nodes;
    uint32_t p[8];
    if (merge) {
      uint32_t m[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m[i] = cvs[t][i];
        m[i + 8] = cvs[t + step][i];
        p[i] = iv(i);
      }
      compress(p, m, 0u, (uint32_t)kBlockBytes,
               kParent | (nodes == 2 ? kRoot : 0u));
    }
    __syncthreads();
    if (merge) {
#pragma unroll
      for (int i = 0; i < 8; ++i) cvs[t][i] = p[i];
    }
    __syncthreads();
  }
  if (live && leaf == 0) {
    out[row] = cvs[t][0];
    out[rows + row] = cvs[t][1];
  }
}

template <int T>
int launch(const void* words, const void* lengths, void* out, int rows,
           int row_words, cudaStream_t stream) {
  const int rows_per_block = T / (row_words / kLeafWords);
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  blake3_kernel<T><<<blocks, T, 0, stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths, (uint32_t*)out, rows,
      row_words);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (2, rows) u32, row 0 = digest words 0 (lo), row 1 = words 1 (hi)
extern "C" int lt_blake3(const void* words, const void* lengths, void* out,
                         int rows, int row_words, void* stream) {
  const int leaves = row_words / kLeafWords;
  const cudaStream_t s = (cudaStream_t)stream;
  if (leaves <= 64) return launch<64>(words, lengths, out, rows, row_words, s);
  if (leaves <= 128) return launch<128>(words, lengths, out, rows, row_words, s);
  if (leaves <= 256) return launch<256>(words, lengths, out, rows, row_words, s);
  if (leaves <= 512) return launch<512>(words, lengths, out, rows, row_words, s);
  return launch<1024>(words, lengths, out, rows, row_words, s);
}
