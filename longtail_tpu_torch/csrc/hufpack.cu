// Backward Huffman bit pack of the zstd literals (RFC 8878 §4.2.1): in
// stream s, literal i's code sits at bit offset sum(len[j] for i < j <
// n_lit[s]), bits stacked LSB-up; the bit total per stream comes out too.
//
// Replaces longtail_tpu/ops/entropy_kernel.py make_hufpack_rows_fn (the
// Pallas bit-merge kernel).  That kernel windows rows of 128 literals,
// builds each window from wrapping prefix sums and merges the windows in
// a tree of rolls, all because Mosaic has no scatter; its grid walks the
// tiles of a stream in order behind a bit carry, so it packs a stream of
// any length.  Here a block packs a piece of at most kMaxLits literals,
// with its words in shared memory, and two entry points cover the TPU
// kernel's domain:
//  - lt_hufpack: every Huffman stream of a zstd frame (up to 64 sections
//    x 4 streams, each at most kMaxLits) in one launch, each with its own
//    section's table, each a whole stream at bit 0 (the zstd device
//    tier's path, one launch per frame);
//  - lt_hufpack_rows: rows of one table and any length, the JAX
//    package's (S, n_pad) interface, cut into pieces of at most kMaxLits
//    literals.  A memset zeroes the rows' words; one launch sums each
//    piece's code lengths (hufbits_kernel); a second packs each piece at
//    the bit total of the pieces after it in its row (the stream is
//    backward), summed from the first launch's totals (hufrows_kernel).
//    A piece's interior words are its own and are stored plainly; its
//    first and last words may be shared with its neighbours and are
//    ORed in with atomicOr (codes of different literals are
//    bit-disjoint, so the ORs are exact in any order).
//   Bound on the H100: a frame holds at most 8 MiB of literals and
// usually far less, so its launch is bound by its round trips, which is
// why the host calls it once per frame; the rows are bound by their
// bytes (the literals read once, the words written once).  Per piece:
//  - Each thread takes a contiguous run of 16 or 32 literals, read as
//    16-byte loads (every piece starts at a 16-byte offset), and looks up
//    their code lengths in the table, held in shared memory.
//  - One block scan of the runs' bit counts, taken from the piece's end,
//    gives each run its bit offset; no literal is read twice.
//  - Each run appends its codes, last literal first, to a 64-bit register
//    and ORs each finished 32-bit word into the piece's words in shared
//    memory (at most kMaxLits x 11 bits + a start of up to 31 bits, 45
//    KB), then the block stores them coalesced.
// The kernels trap on a piece outside the buffers or longer than
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
// a piece packed from bit 31 of its first word still fits: the spill word
// of words_for covers the start (ceil((31 + b) / 32) <= (b + 31) / 32 + 1)
static_assert((31 + kMaxLits * kMaxBits + 31) / 32 <= kMaxWords,
              "a piece starting at bit 31 overflows its shared words");

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

// the code table (256 entries val | len << 16) into shared memory
__device__ __forceinline__ void load_table(uint32_t* tab,
                                           const int32_t* table) {
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    const uint32_t e = (uint32_t)table[i];
    const uint32_t len = e >> 16, val = e & 0xffffu;
    if (len > (uint32_t)kMaxBits || (val >> len) != 0u) __trap();
    tab[i] = e;
  }
}

// this thread's run of the n literals at p (16-byte aligned): literals
// [a, a + m) into q; returns m
__device__ __forceinline__ int load_run(const uint8_t* p, int n,
                                        uint4 q[2]) {
  const int run = n <= 16 * kThreads ? 16 : 32;
  const int a = threadIdx.x * run;
  const int m = max(0, min(run, n - a));
  const uint4* src = reinterpret_cast<const uint4*>(p + a);
  q[0] = q[1] = make_uint4(0u, 0u, 0u, 0u);
  if (m > 0) q[0] = __ldg(src);
  if (m > 16) q[1] = __ldg(src + 1);
  return m;
}

// code bits of the run's m literals
__device__ __forceinline__ int run_bits(const uint32_t* tab,
                                        const uint4 q[2], int m) {
  int bits = 0;
#pragma unroll
  for (int j = 0; j < kMaxRun; ++j) {
    if (j < m) bits += (int)(tab[byte_at(q, j)] >> 16);
  }
  return bits;
}

// the piece's codes into acc (zeroed, synchronised) from bit start:
// returns the piece's bit total; acc is complete when it returns
__device__ __forceinline__ int pack_piece(uint32_t* acc, int* sums,
                                          const uint32_t* tab,
                                          const uint4 q[2], int m,
                                          int start) {
  const int incl = block_inclusive_sum(run_bits(tab, q, m), sums);
  const int total = sums[kWarps - 1];
  if (m > 0) {
    const int base = start + total - incl;  // bits of the later runs
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
  return total;
}

// the frame: one block per stream, packed at bit 0, every one of its
// words_for(n_lit) words stored
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
  load_table(tab, tables + 256 * k);
  for (int i = tid; i < W; i += kThreads) acc[i] = 0u;
  uint4 q[2];
  const int m = load_run(lits + off, n, q);
  __syncthreads();                          // tab and acc ready
  const int total = pack_piece(acc, sums, tab, q, m, 0);
  for (int i = tid; i < W; i += kThreads) words[woff + i] = acc[i];
  if (tid == 0) totals[s] = total;
}

// a piece of the rows: (first literal, n literals, row, pieces after it
// in its row), the row's pieces consecutive in literal order
struct Piece {
  int off, n, row, later;
};

__device__ __forceinline__ Piece piece_at(const int32_t* pieces, int p,
                                          int n_pieces, long long n_lits,
                                          int n_rows) {
  const Piece c = {pieces[4 * p], pieces[4 * p + 1], pieces[4 * p + 2],
                   pieces[4 * p + 3]};
  if (c.n < 0 || c.n > kMaxLits || c.off < 0 || (c.off & 15) ||
      (long long)c.off + c.n > n_lits || c.row < 0 || c.row >= n_rows ||
      c.later < 0 || c.later >= n_pieces - p ||
      pieces[4 * (p + c.later) + 2] != c.row) {
    __trap();                               // a piece outside the buffers
  }
  return c;
}

// launch 1: each piece's bit total
__global__ void __launch_bounds__(kThreads)
hufbits_kernel(const uint8_t* __restrict__ lits, long long n_lits,
               const int32_t* __restrict__ pieces,
               const int32_t* __restrict__ table, int32_t* __restrict__ bits,
               int n_pieces, int n_rows) {
  __shared__ uint32_t tab[256];
  __shared__ int sums[kWarps];
  const int p = blockIdx.x;
  const Piece c = piece_at(pieces, p, n_pieces, n_lits, n_rows);
  load_table(tab, table);
  uint4 q[2];
  const int m = load_run(lits + c.off, c.n, q);
  __syncthreads();
  block_inclusive_sum(run_bits(tab, q, m), sums);
  if (threadIdx.x == 0) bits[p] = sums[kWarps - 1];
}

// launch 2: each piece packed at the bit total of the later pieces of
// its row into the zeroed words (row_words a row); the row's first piece
// writes the row's total
__global__ void __launch_bounds__(kThreads)
hufrows_kernel(const uint8_t* __restrict__ lits, long long n_lits,
               const int32_t* __restrict__ pieces,
               const int32_t* __restrict__ table,
               const int32_t* __restrict__ bits, uint32_t* __restrict__ words,
               int32_t* __restrict__ totals, int n_pieces, int n_rows,
               int row_words) {
  __shared__ uint32_t tab[256];
  __shared__ uint32_t acc[kMaxWords];
  __shared__ int sums[kWarps];
  __shared__ int start_s;
  const int p = blockIdx.x, tid = threadIdx.x;
  const Piece c = piece_at(pieces, p, n_pieces, n_lits, n_rows);
  load_table(tab, table);
  for (int i = tid; i < words_for(c.n); i += kThreads) acc[i] = 0u;
  if (tid < 32) {                           // bits of the later pieces
    int later = 0;
    for (int j = 1 + tid; j <= c.later; j += 32) later += bits[p + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      later += __shfl_down_sync(0xffffffffu, later, o);
    }
    if (tid == 0) start_s = later;
  }
  uint4 q[2];
  const int m = load_run(lits + c.off, c.n, q);
  __syncthreads();                          // tab, acc and start ready
  const int start = start_s, sh = start & 31;
  const int total = pack_piece(acc, sums, tab, q, m, sh);
  const int count = (sh + total + 31) >> 5;  // words the piece touches
  if ((start >> 5) + count > row_words) __trap();
  uint32_t* out = words + (long long)c.row * row_words + (start >> 5);
  for (int i = tid; i < count; i += kThreads) {
    const uint32_t v = acc[i];
    if (i == 0 || i == count - 1) {         // maybe a neighbour's too
      if (v) atomicOr(&out[i], v);
    } else {
      out[i] = v;
    }
  }
  if (tid == 0 && (p == 0 || pieces[4 * (p - 1) + 2] != c.row)) {
    totals[c.row] = start + total;
  }
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

// lits (n_lits,) u8, the rows end to end, every piece at a 16-byte
// offset; pieces (n_pieces, 4) i32 = (literal offset, n literals, row,
// pieces after it in its row), every row's pieces consecutive in literal
// order and every row with at least one; table (256,) i32 = val | len <<
// 16; bits (n_pieces,) i32 scratch -> words (n_rows, row_words) u32,
// zeroed here and then packed, totals (n_rows,) i32
extern "C" int lt_hufpack_rows(const void* lits, long long n_lits,
                               const void* pieces, const void* table,
                               void* bits, void* words, void* totals,
                               int n_pieces, int n_rows, int row_words,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_rows > 0) {
    const cudaError_t e = cudaMemsetAsync(
        words, 0, (size_t)n_rows * (size_t)row_words * sizeof(uint32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_pieces > 0) {
    hufbits_kernel<<<(unsigned)n_pieces, kThreads, 0, st>>>(
        (const uint8_t*)lits, n_lits, (const int32_t*)pieces,
        (const int32_t*)table, (int32_t*)bits, n_pieces, n_rows);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    hufrows_kernel<<<(unsigned)n_pieces, kThreads, 0, st>>>(
        (const uint8_t*)lits, n_lits, (const int32_t*)pieces,
        (const int32_t*)table, (const int32_t*)bits, (uint32_t*)words,
        (int32_t*)totals, n_pieces, n_rows, row_words);
  }
  return (int)cudaGetLastError();
}
