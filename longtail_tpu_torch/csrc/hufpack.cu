// Backward Huffman bit pack of the zstd literals (RFC 8878 §4.2.1): in
// stream s, literal i's code sits at bit offset sum(len[j] for i < j <
// n_lit[s]), bits stacked LSB-up; the bit total per stream comes out too.
//
// Replaces longtail_tpu/ops/entropy_kernel.py make_hufpack_rows_fn (the
// Pallas bit-merge kernel).  That kernel windows rows of 128 literals,
// builds each window from wrapping prefix sums and merges the windows in
// a tree of rolls, all because Mosaic has no scatter.  A GPU has atomics:
// a code is at most 11 bits, so it touches at most two u32 words, and the
// codes of different literals are bit-disjoint, so atomicOr into a zeroed
// output is exact in any order and the result is deterministic.
//   Bound on the H100: launch and latency.  The main path packs S <= 4
// streams of n_pad <= 32768 literals (one 128 KiB zstd block), a few
// blocks per call and ~100 KB of traffic, so neither bandwidth nor ALU
// bounds it.  Design: a grid over (tile of 1024 literals, stream), one
// literal per thread.  Each block first adds up the code lengths of the
// literals after its tile (at most 31 tiles of them per stream, read
// straight from the input: no second pass and no scratch), then a block
// scan of its own tile's lengths gives every thread its bit offset.  The
// 256-entry code table (val | len << 16) lives in shared memory.  The
// first tile's block writes the stream's total.
//
// The output words must be zeroed by the caller; W words per stream cover
// every offset because each code length is at most 11 (the host checks
// the table).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;                 // literals per block
constexpr int kWarps = kTile / 32;

// the sum of v over the block, in every thread
__device__ __forceinline__ int block_sum(int v, int* sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                          // sums may still be in use
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sums[w];
  return t;
}

// inclusive prefix sum of v over the block; sums[kWarps - 1] ends up
// holding the block total
__device__ __forceinline__ int block_inclusive_sum(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  __syncthreads();                          // sums may still be in use
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {                          // kWarps == 32: one warp scans
    int w = sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sums[lane] = w;
  }
  __syncthreads();
  return v + (warp > 0 ? sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(kTile)
hufpack_kernel(const uint8_t* __restrict__ lits,
               const int32_t* __restrict__ n_lit,
               const int32_t* __restrict__ table, uint32_t* __restrict__ out,
               int32_t* __restrict__ totals, int n_pad, int W) {
  __shared__ uint32_t tab[256];
  __shared__ int sums[kWarps];
  const int s = blockIdx.y;
  const int tile0 = blockIdx.x * kTile;
  const int n = min(n_lit[s], n_pad);
  if (tile0 >= n && blockIdx.x > 0) return;  // the whole block: no codes
  const uint8_t* row = lits + (long long)s * n_pad;
  for (int i = threadIdx.x; i < 256; i += kTile) tab[i] = (uint32_t)table[i];
  __syncthreads();

  int later = 0;                            // bits of the later tiles
  for (int i = tile0 + kTile + threadIdx.x; i < n; i += kTile) {
    later += (int)(tab[row[i]] >> 16);
  }
  later = block_sum(later, sums);

  const int i = tile0 + threadIdx.x;
  const uint32_t e = i < n ? tab[row[i]] : 0u;
  const int len = (int)(e >> 16);
  const uint32_t val = e & 0xffffu;
  const int incl = block_inclusive_sum(len, sums);
  const int tile_bits = sums[kWarps - 1];
  const int off = later + tile_bits - incl;  // bits of the literals after i
  if (len > 0) {
    uint32_t* w = out + (long long)s * W + (off >> 5);
    const int sh = off & 31;
    atomicOr(w, val << sh);
    if (sh + len > 32) atomicOr(w + 1, val >> (32 - sh));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) totals[s] = later + tile_bits;
}

}  // namespace

// lits (S, n_pad) u8, n_lit (S,) i32, table (256,) i32 = val | len << 16,
// out (S, W) u32 zeroed, totals (S,) i32
extern "C" int lt_hufpack(const void* lits, const void* n_lit,
                          const void* table, void* out, void* totals,
                          int n_streams, int n_pad, int W, void* stream) {
  const dim3 grid((unsigned)((n_pad + kTile - 1) / kTile),
                  (unsigned)n_streams);
  hufpack_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)lits, (const int32_t*)n_lit, (const int32_t*)table,
      (uint32_t*)out, (int32_t*)totals, n_pad, W);
  return (int)cudaGetLastError();
}
