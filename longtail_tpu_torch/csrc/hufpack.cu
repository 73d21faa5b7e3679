// Backward Huffman bit pack of the zstd literals (RFC 8878 §4.2.1) of a
// whole zstd frame in one launch: in stream s, literal i's code sits at
// bit offset sum(len[j] for i < j < n_lit[s]), bits stacked LSB-up; the bit
// total per stream comes out too.
//
// Replaces longtail_tpu/ops/entropy_kernel.py make_hufpack_rows_fn (the
// Pallas bit-merge kernel).  That kernel windows rows of 128 literals,
// builds each window from wrapping prefix sums and merges the windows in
// a tree of rolls, all because Mosaic has no scatter, and runs once per
// literal section.  Here one launch packs every Huffman stream of a frame
// (up to 64 sections x 4 streams), each with its own section's table.
//   Bound on the H100: launch and latency.  A frame's streams hold at most
// 8 MiB of literals and usually far less, so neither bandwidth nor the ALU
// bounds the kernel; what costs is each call's round trips, which is why
// the host calls it once per frame.  Design: one block per stream (a
// stream holds at most kMaxLits literals).
//  - Each thread takes a contiguous run of 16 or 32 literals, read as
//    16-byte loads (the host puts every stream at a 16-byte offset), and
//    looks up their code lengths in the section's table, held in shared
//    memory.
//  - One block scan of the runs' bit counts, taken from the stream's end,
//    gives each run its bit offset; no literal is read twice.
//  - Each run appends its codes, last literal first, to a 64-bit register
//    and ORs each finished 32-bit word into the stream's words in shared
//    memory (at most kMaxLits x 11 bits = 45 KB): codes of different
//    literals are bit-disjoint, so the ORs are exact in any order.  No
//    global zero-fill, no global atomics.
//  - The block stores the stream's words coalesced, every one of its
//    words_for(n_lit) words, and its bit total.
// The kernel traps on a stream outside the buffers or longer than
// kMaxLits, and on a table entry longer than kMaxBits or whose value does
// not fit its length.

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(LT_HUF_MAX_BITS) || !defined(LT_HUF_MAX_LITS)
#error "build through longtail_tpu_torch/_kernels.py, which defines the code limits"
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBits = LT_HUF_MAX_BITS;
constexpr int kMaxLits = LT_HUF_MAX_LITS;
constexpr int kMaxRun = kMaxLits / kThreads;  // literals a thread
static_assert(kWarps == 32, "one warp scans the warp sums");
static_assert(kMaxRun == 32 && kMaxLits % kThreads == 0,
              "a run is one or two 16-byte loads");

// words of a stream of n literals: every code at most kMaxBits bits, plus
// a spill word (ops/entropy_kernel.py words_per_stream)
__device__ __forceinline__ int words_for(int n) {
  return (n * kMaxBits + 31) / 32 + 1;
}
constexpr int kMaxWords = (kMaxLits * kMaxBits + 31) / 32 + 1;

// byte j of the run held in q (j a compile-time constant once unrolled)
__device__ __forceinline__ uint32_t byte_at(const uint4 q[2], int j) {
  const uint4 v = q[j >> 4];
  const int w = (j >> 2) & 3;
  const uint32_t word = w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
  return (word >> (8 * (j & 3))) & 0xffu;
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
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
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

__global__ void __launch_bounds__(kThreads)
hufpack_kernel(const uint8_t* __restrict__ lits, long long n_lits,
               const int32_t* __restrict__ streams,
               const int32_t* __restrict__ tables,
               uint32_t* __restrict__ words, int32_t* __restrict__ totals,
               int n_tables, int n_words) {
  __shared__ uint32_t tab[256];
  __shared__ uint32_t acc[kMaxWords];
  __shared__ int sums[kWarps];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int off = streams[4 * s], n = streams[4 * s + 1];
  const int k = streams[4 * s + 2], woff = streams[4 * s + 3];
  if (n < 0 || n > kMaxLits || off < 0 || (off & 15) ||
      (long long)off + n > n_lits || k < 0 || k >= n_tables || woff < 0 ||
      (long long)woff + words_for(n) > n_words) {
    __trap();                               // a stream outside the buffers
  }
  const int W = words_for(n);
  for (int i = tid; i < 256; i += kThreads) {
    const uint32_t e = (uint32_t)tables[256 * k + i];
    const uint32_t len = e >> 16, val = e & 0xffffu;
    if (len > (uint32_t)kMaxBits || (val >> len) != 0u) __trap();
    tab[i] = e;
  }
  for (int i = tid; i < W; i += kThreads) acc[i] = 0u;

  // this thread's run: literals [a, a + m) of the stream
  const int run = n <= 16 * kThreads ? 16 : 32;
  const int a = tid * run;
  const int m = max(0, min(run, n - a));
  const uint4* src = reinterpret_cast<const uint4*>(lits + off + a);
  uint4 q[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (m > 0) q[0] = __ldg(src);
  if (m > 16) q[1] = __ldg(src + 1);
  __syncthreads();                          // tab and acc ready

  int bits = 0;
#pragma unroll
  for (int j = 0; j < kMaxRun; ++j) {
    if (j < m) bits += (int)(tab[byte_at(q, j)] >> 16);
  }
  const int incl = block_inclusive_sum(bits, sums);
  const int total = sums[kWarps - 1];
  const int base = total - incl;            // bits of the later runs

  if (m > 0) {
    int w = base >> 5, fill = base & 31;
    unsigned long long buf = 0ull;
#pragma unroll
    for (int j = kMaxRun - 1; j >= 0; --j) {
      if (j < m) {
        const uint32_t e = tab[byte_at(q, j)];
        buf |= (unsigned long long)(e & 0xffffu) << fill;
        fill += (int)(e >> 16);
        if (fill >= 32) {
          atomicOr(&acc[w], (uint32_t)buf);
          buf >>= 32;
          fill -= 32;
          ++w;
        }
      }
    }
    if (fill > 0) atomicOr(&acc[w], (uint32_t)buf);
  }
  __syncthreads();
  for (int i = tid; i < W; i += kThreads) words[woff + i] = acc[i];
  if (tid == 0) totals[s] = total;
}

}  // namespace

// lits (n_lits,) u8, every stream at a 16-byte offset and n_lits a
// multiple of 16; streams (n_streams, 4) i32 = (literal offset, n_lit,
// table index, word offset); tables (n_tables, 256) i32 = val | len << 16
// -> words (n_words,) u32 (stream s's words_for(n_lit) words at its
// offset), totals (n_streams,) i32
extern "C" int lt_hufpack(const void* lits, long long n_lits,
                          const void* streams, const void* tables,
                          void* words, void* totals, int n_streams,
                          int n_tables, int n_words, void* stream) {
  if (n_streams > 0) {
    hufpack_kernel<<<(unsigned)n_streams, kThreads, 0,
                     (cudaStream_t)stream>>>(
        (const uint8_t*)lits, n_lits, (const int32_t*)streams,
        (const int32_t*)tables, (uint32_t*)words, (int32_t*)totals,
        n_tables, n_words);
  }
  return (int)cudaGetLastError();
}
