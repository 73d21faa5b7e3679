// BLAKE3-64 of chunks where they lie in a flat byte batch: the 16
// compressions of every 1 KiB leaf, then the left-leaning tree merge of
// each chunk's leaves.  The 64-bit digest is the first two output words.
//
// Replaces longtail_tpu/ops/blake3_kernel.py _make_hash_fn (its
// `_hash_kernel` / `_hash_tile`) and, on this path, the pack kernel in
// front of it.  The TPU kernel hashes rows that pack has copied into
// aligned, zero-padded words of a power-of-two size class, because a DMA
// reads aligned windows; a GPU thread reads any address, so this kernel
// reads each chunk's bytes once, where they are, and hashes every chunk of
// a batch in one launch.
//   Bound on the H100: integer ALU work (7 rounds of 8 G functions, 12
// operations each, per 64-byte block), not bandwidth.  Design:
//  - Work plan.  The host (ops/blake3.py plan_blocks) gives each block of
//    kThreads threads the whole chunks whose first leaf falls in its range
//    of kThreads leaves: at most kThreads chunks and kThreads - 1 +
//    kMaxLeaves leaves.  No thread is given a leaf past its chunk's end,
//    and there are no size classes.
//  - Leaves.  The block scans its chunks' leaf counts into leaf offsets in
//    shared memory; its threads take the block's leaves in turn, find
//    their chunk by binary search and run its compressions with the state
//    and message in registers.  A 64-byte block is five 16-byte loads,
//    aligned down, and one funnel shift per word; bytes past the chunk's
//    size are zeroed in registers (what pack's padding used to provide).
//    The next block's loads are issued before the current compression.
//  - Merge.  Leaf chaining values sit in shared memory at their leaf slot.
//    Level by level, node pairs (2j, 2j + 1) of each chunk merge into the
//    left one with PARENT (ROOT on a chunk's last merge) and an odd node
//    carries up in place, as blake3_kernel.py does.  A level's merges of
//    all the block's chunks are numbered by an exclusive scan and taken by
//    the first threads, so whole warps idle instead of every warp running
//    the compression with a few lanes.  A chunk of size 0 hashes the empty
//    input.
// The plan must hold (the kernel traps otherwise): at most kThreads chunks
// and kSlots leaves a block, every chunk inside the batch.
//   The experiments of tools/profile_torch_codecs.py --kernel-variants are
// builds with LT_VARIANT_NO_LOADS (the chunk bytes made in registers) or
// LT_VARIANT_NO_MERGE (the tree merge skipped) defined.  Each removes one
// part of the work and computes wrong results; the library defines neither.

#include <cstdint>
#include <cuda_runtime.h>

#include "chunk_bytes.cuh"

#if !defined(LT_BLAKE3_IV0) || !defined(LT_BLAKE3_THREADS)
#error "build through longtail_tpu_torch/_kernels.py, which defines the algorithm constants"
#endif

namespace {

using chunk_bytes::fetch_block;
using chunk_bytes::load_block;

constexpr uint32_t kChunkStart = LT_BLAKE3_CHUNK_START;
constexpr uint32_t kChunkEnd = LT_BLAKE3_CHUNK_END;
constexpr uint32_t kParent = LT_BLAKE3_PARENT;
constexpr uint32_t kRoot = LT_BLAKE3_ROOT;
constexpr int kBlockBytes = LT_BLAKE3_BLOCK_BYTES;
constexpr int kLeafBytes = LT_BLAKE3_LEAF_BYTES;
constexpr int kThreads = LT_BLAKE3_THREADS;     // threads, and leaves planned, a block
constexpr int kMaxLeaves = LT_BLAKE3_MAX_LEAVES;
constexpr int kSlots = kThreads + kMaxLeaves;   // leaves a block can hold
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kBlockBytes == chunk_bytes::kBlockBytes,
              "16 message words of 4 bytes");

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

// exclusive prefix sum of x over the block; *total = the sum.  Ends with
// a barrier after its reads of `tot`, so calls may follow one another.
__device__ int block_exclusive_scan(int x, int* total, int* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    before += k < warp ? tot[k] : 0;
    sum += tot[k];
  }
  __syncthreads();
  *total = sum;
  return before + incl - x;
}

// the last c < n with key[c] <= i (key ascending, key[0] <= i)
__device__ __forceinline__ int owner(const int* key, int n, int i) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (key[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
blake3_kernel(const uint8_t* __restrict__ bytes,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ sizes,
              const int32_t* __restrict__ plan, uint32_t* __restrict__ out,
              int n_chunks, long long n_bytes) {
  __shared__ uint32_t cvs[8][kSlots];       // chaining value of each slot
  __shared__ int c_start[kThreads], c_size[kThreads];
  __shared__ int c_leaf[kThreads + 1];      // first leaf slot of each chunk
  __shared__ int c_task[kThreads + 1];      // first merge of each chunk
  __shared__ int tot[kWarps];

  const int tid = threadIdx.x;
  const int c0 = plan[blockIdx.x];
  const int nc = plan[blockIdx.x + 1] - c0;
  if (nc > kThreads) __trap();
  int leaves = 0;
  if (tid < nc) {
    c_start[tid] = starts[c0 + tid];
    c_size[tid] = sizes[c0 + tid];
    if (c_start[tid] < 0 || c_size[tid] < 0 ||
        (long long)c_start[tid] + c_size[tid] > n_bytes) {
      __trap();                             // a chunk outside the batch
    }
    leaves = max((c_size[tid] + kLeafBytes - 1) / kLeafBytes, 1);
  }
  int total;
  const int first = block_exclusive_scan(leaves, &total, tot);
  if (total > kSlots) __trap();
  if (tid < nc) c_leaf[tid] = first;
  if (tid == 0) c_leaf[nc] = total;
  __syncthreads();

  // leaves: slot i is leaf j of chunk c
  for (int i = tid; i < total; i += kThreads) {
    const int c = owner(c_leaf, nc, i);
    const int j = i - c_leaf[c];
    const bool single = c_leaf[c + 1] - c_leaf[c] == 1;
    const int leaf_len = min(max(c_size[c] - j * kLeafBytes, 0), kLeafBytes);
    const int n_blocks = max((leaf_len + kBlockBytes - 1) / kBlockBytes, 1);
    const long long a = (long long)c_start[c] + (long long)j * kLeafBytes;
    uint32_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = iv(k);
    // the next block's loads are in flight during this one's compression
    uint4 q[5];
    fetch_block(bytes, a, min(leaf_len, kBlockBytes), q);
    for (int k = 0; k < n_blocks; ++k) {
      const int blen = min(leaf_len - k * kBlockBytes, kBlockBytes);
      uint32_t m[16];
      load_block(q, a + k * kBlockBytes, blen, m);
      if (k + 1 < n_blocks) {
        fetch_block(bytes, a + (k + 1) * kBlockBytes,
                    min(leaf_len - (k + 1) * kBlockBytes, kBlockBytes), q);
      }
      const bool last = k == n_blocks - 1;
      const uint32_t flags = (k == 0 ? kChunkStart : 0u) |
                             (last ? kChunkEnd : 0u) |
                             (last && single ? kRoot : 0u);
      compress(h, m, (uint32_t)j, (uint32_t)blen, flags);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) cvs[k][i] = h[k];
  }
  __syncthreads();

  // merge levels: node t of a chunk sits at its slot t * step; a merge
  // reads slots 2 t step and (2 t + 1) step and writes the first, so the
  // merges of a level touch disjoint slots
  for (int step = 1;; step <<= 1) {
    int nodes = 0;
    if (tid < nc) nodes = (c_leaf[tid + 1] - c_leaf[tid] + step - 1) / step;
    int merges;
    const int before = block_exclusive_scan(nodes / 2, &merges, tot);
#ifdef LT_VARIANT_NO_MERGE
    break;
#endif
    if (merges == 0) break;
    if (tid < nc) c_task[tid] = before;
    __syncthreads();
    for (int t = tid; t < merges; t += kThreads) {
      const int c = owner(c_task, nc, t);
      const int k = t - c_task[c];
      const int n = (c_leaf[c + 1] - c_leaf[c] + step - 1) / step;
      const int left = c_leaf[c] + 2 * k * step;
      uint32_t m[16], p[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        m[q] = cvs[q][left];
        m[q + 8] = cvs[q][left + step];
        p[q] = iv(q);
      }
      compress(p, m, 0u, (uint32_t)kBlockBytes, kParent | (n == 2 ? kRoot : 0u));
#pragma unroll
      for (int q = 0; q < 8; ++q) cvs[q][left] = p[q];
    }
    __syncthreads();
  }
  if (tid < nc) {
    out[c0 + tid] = cvs[0][c_leaf[tid]];
    out[n_chunks + c0 + tid] = cvs[1][c_leaf[tid]];
  }
}

}  // namespace

// out: (2, n_chunks) u32, row 0 = digest words 0 (lo), row 1 = words 1
// (hi); plan: (n_blocks + 1,) first chunk of each block (plan_blocks)
extern "C" int lt_blake3(const void* bytes, long long n_bytes,
                         const void* starts, const void* sizes,
                         const void* plan, void* out, int n_chunks,
                         int n_blocks, void* stream) {
  if (n_blocks > 0) {
    blake3_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bytes, (const int32_t*)starts,
        (const int32_t*)sizes, (const int32_t*)plan, (uint32_t*)out,
        n_chunks, n_bytes);
  }
  return (int)cudaGetLastError();
}
