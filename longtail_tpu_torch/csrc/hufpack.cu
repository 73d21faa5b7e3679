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
//    literals, in one launch and nothing else: a block per piece reads
//    its literals once, learns its bit offset (the bits of the pieces
//    after it in its row: the stream is backward) by a single-pass
//    look-back over their published totals, packs, and hands the word
//    it shares with the piece above to that piece, which stores it; so
//    every word is stored once, with no memset and no global atomic on
//    the words (hufrows_kernel).
//   Bound on the H100: a frame holds at most 8 MiB of literals and
// usually far less, so its launch is bound by its round trips, which is
// why the host calls it once per frame; the rows' least time is their
// bytes' (the literals read once, the words written once), but the
// kernel takes about three times that, held by the code-length scan and
// the pack, each a chain of dependent integer steps per thread, and by
// each block's waits on its loads and on the pieces after it
// (tools/profile_torch_hufrows.py times the kernel without each).  Per
// piece:
//  - Each thread takes a contiguous run of 16 or 32 literals, read as
//    16-byte loads (every piece starts at a 16-byte offset), and looks up
//    their code lengths in the table, held in shared memory.
//  - One block scan of the runs' bit counts, taken from the piece's end,
//    gives each run its bit offset; no literal is read twice.
//  - Each run appends its codes, last literal first, two at a time to a
//    64-bit register and ORs each finished 32-bit word into the piece's
//    words in shared memory (at most kMaxLits x 11 bits + a start of up
//    to 31 bits, 45 KB), then the block stores them coalesced.
// The kernels trap on a stream outside the buffers or longer than
// kMaxLits, on a ticket outside the call's or a status that never comes,
// and on a table entry longer than kMaxBits or whose value does not fit
// its length.

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
    bits += j < m ? (int)(tab[byte_at(q, j)] >> 16) : 0;
  }
  return bits;
}

// the run's m codes into acc, last literal first, from bit base of acc:
// two codes at a time onto fewer than 32 pending bits, after which at
// most one word is done, ORed in (codes of different runs may share a
// word), with no branch that splits the warp
static_assert(31 + 2 * kMaxBits < 64 && kMaxRun % 2 == 0,
              "two codes on 31 pending bits overflow the 64-bit buffer");
__device__ __forceinline__ void pack_codes(uint32_t* acc,
                                           const uint32_t* tab,
                                           const uint4 q[2], int m,
                                           int base) {
  int w = base >> 5, fill = base & 31;
  unsigned long long buf = 0ull;
#pragma unroll
  for (int j = kMaxRun - 1; j > 0; j -= 2) {
    const uint32_t e1 = j < m ? tab[byte_at(q, j)] : 0u;
    buf |= (unsigned long long)(e1 & 0xffffu) << fill;
    fill += (int)(e1 >> 16);
    const uint32_t e0 = j - 1 < m ? tab[byte_at(q, j - 1)] : 0u;
    buf |= (unsigned long long)(e0 & 0xffffu) << fill;
    fill += (int)(e0 >> 16);
    const bool done = fill >= 32;
    if (done) atomicOr(&acc[w], (uint32_t)buf);
    buf = done ? buf >> 32 : buf;
    fill -= done ? 32 : 0;
    w += done;
  }
  if (fill > 0) atomicOr(&acc[w], (uint32_t)buf);
}

// the piece's codes into acc (zeroed, synchronised) from bit start:
// returns the piece's bit total; acc is complete when it returns
__device__ __forceinline__ int pack_piece(uint32_t* acc, int* sums,
                                          const uint32_t* tab,
                                          const uint4 q[2], int m,
                                          int start) {
  const int incl = block_inclusive_sum(run_bits(tab, q, m), sums);
  const int total = sums[kWarps - 1];
  if (m > 0) pack_codes(acc, tab, q, m, start + total - incl);
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

// The rows: one block per piece, in ticket order, and one word of
// status per piece in a work buffer that outlives the call (see
// lt_hufpack_rows).  A status is (call epoch << 33 | state << 31 |
// value): state kAggregate carries the piece's own bit total, kInclusive
// and kEdge the bits of the piece and every later piece of its row
// (its inclusive total); kEdge also says that the piece's edge word is
// in edges[].  An epoch other than the call's reads as "not yet".
constexpr unsigned long long kAggregate = 1ull, kInclusive = 2ull,
                             kEdge = 3ull;

// a status, relaxed but for kEdge, which releases the edge word this
// thread wrote before it to whoever acquires the status
__device__ __forceinline__ void publish(unsigned long long* status,
                                        unsigned epoch,
                                        unsigned long long state,
                                        int value) {
  const unsigned long long v =
      (unsigned long long)epoch << 33 | state << 31 | (unsigned)value;
  if (state == kEdge) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(status),
                 "l"(v) : "memory");
  } else {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(status),
                 "l"(v) : "memory");
  }
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p, bool acquire) {
  unsigned long long v;
  if (acquire) {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
  } else {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
  }
  return v;
}

// whether status v is this call's and at least state
__device__ __forceinline__ bool status_is(unsigned long long v,
                                          unsigned epoch,
                                          unsigned long long state) {
  return (unsigned)(v >> 33) == epoch && ((v >> 31) & 3ull) >= state;
}

// the status once it is this call's and at least state (acquired for
// kEdge); spins, and traps after ~2^24 polls (seconds) rather than hang
// the card on a status that never comes
__device__ __forceinline__ unsigned long long await_status(
    const unsigned long long* status, unsigned epoch,
    unsigned long long state) {
  for (int polls = 0; polls < (1 << 24); ++polls) {
    const unsigned long long v = load_status(status, state == kEdge);
    if (status_is(v, epoch, state)) return v;
    __nanosleep(20);
  }
  __trap();
}

__device__ __forceinline__ int status_value(unsigned long long v) {
  return (int)(v & 0x7fffffffull);
}

// sum of v over the warp
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the bits of word w that pieces k0, k0 + 1, ... of the row hold: the OR
// of the edge words of the pieces whose inclusive total passes 32 w (a
// piece's edge word is its part of the word its inclusive total ends in;
// inclusive totals fall along the row, so the first piece that does not
// pass 32 w ends the search)
__device__ uint32_t gather_edges(const unsigned long long* status,
                                 const uint32_t* edges, int k0, int M,
                                 int w, unsigned epoch) {
  uint32_t word = 0u;
  for (int k = k0; k < M; ++k) {
    if (status_value(await_status(status + k, epoch, kInclusive)) <= 32 * w) {
      break;
    }
    await_status(status + k, epoch, kEdge);  // acquires the edge word
    word |= *(const volatile uint32_t*)(edges + k);
  }
  return word;
}

// One launch packs every row (n_pad literal slots, n_lit[s] of them live)
// into row_words words of its own.  A row has M pieces of at most
// kMaxLits literals, and Z slices of zero_words words.  Each block takes
// a ticket: ticket t < n_rows x M is piece M - 1 - t / n_rows of row t %
// n_rows, so the pieces at the end of every row go first; the tickets
// after the pieces' are the slices, row after row.  A block waits only on
// blocks of lower tickets, which are running or done.  Piece m of a row:
//  1. reads its literals once into registers, scans their code lengths
//     and publishes its bit total t (kAggregate);
//  2. its bit offset is the bits of the later pieces of its row: warp 0
//     adds their aggregates, 32 at a time, up to the nearest inclusive
//     total (single-pass decoupled look-back, run backwards as the stream
//     is), and publishes off + t (kInclusive);
//  3. packs its codes at bit off & 31 of its words in shared memory and
//     publishes its edge word (kEdge): its bits in word (off + t) >> 5,
//     the word it shares with the piece above;
//  4. stores, coalesced and once each, the words whose top bit it holds,
//     [off >> 5, (off + t) >> 5), its first word ORed with the edge words
//     of the later pieces that reach into it; the row's first piece (m =
//     0) also stores the word the row's total ends in (the edge words of
//     the pieces that reach it) and the row's total.
// Slice z of a row waits for the row's first piece's inclusive total (the
// row's) and stores zeros over what of [z x zero_words, (z + 1) x
// zero_words) lies past it, so that no one block writes a long row's tail
// alone.  Every word of a row is stored by exactly one block, with no
// memset and no atomic on the words.
//   For tools/profile_torch_hufrows.py only, the kernel builds with
// LT_VARIANT_NO_LENGTHS (each literal taken as 5 bits, no table lookup
// in the scan) or LT_VARIANT_NO_PACK (no code packed) defined; each
// removes one part of the work and computes wrong words.
__global__ void __launch_bounds__(kThreads)
hufrows_kernel(const uint8_t* __restrict__ lits,
               const int32_t* __restrict__ n_lit,
               const int32_t* __restrict__ table, uint32_t* __restrict__ words,
               int32_t* __restrict__ totals, unsigned* __restrict__ ticket,
               unsigned long long* __restrict__ status,
               uint32_t* __restrict__ edges, int n_rows, int n_pad,
               int row_words, int zero_words, unsigned epoch,
               unsigned base) {
  __shared__ uint32_t tab[256];
  __shared__ uint32_t acc[kMaxWords];
  __shared__ int sums[kWarps];
  __shared__ int ticket_s, off_s;
  __shared__ uint32_t first_s, top_s;
  const int tid = threadIdx.x, lane = tid & 31;
  const int M = max(1, (n_pad + kMaxLits - 1) / kMaxLits);
  const int Z = (row_words + zero_words - 1) / zero_words;
  if (tid == 0) ticket_s = (int)(atomicAdd(ticket, 1u) - base);
  load_table(tab, table);
  __syncthreads();                          // tab and the ticket ready
  const int t = ticket_s;
  if (t < 0 || t >= n_rows * (M + Z)) __trap();  // another call's ticket
  if (t >= n_rows * M) {                    // slice z of row s's zeros
    const int s = (t - n_rows * M) / Z, z = (t - n_rows * M) % Z;
    if (tid == 0) {
      off_s = status_value(
          await_status(status + (long long)s * M, epoch, kInclusive));
    }
    __syncthreads();
    uint32_t* const out = words + (long long)s * row_words;
    const int end = min(row_words, (z + 1) * zero_words);
    for (int i = max(z * zero_words, (off_s + 31) >> 5) + tid; i < end;
         i += kThreads) {
      out[i] = 0u;
    }
    return;
  }
  const int m = M - 1 - t / n_rows, s = t % n_rows;
  const int first = m * kMaxLits;
  const int n = min(max(min(max(n_lit[s], 0), n_pad) - first, 0), kMaxLits);
  unsigned long long* const st = status + (long long)s * M;
  uint32_t* const ed = edges + (long long)s * M;
  for (int i = tid; i < words_for(n); i += kThreads) acc[i] = 0u;
  uint4 q[2];
  const int r = load_run(lits + (long long)s * n_pad + first, n, q);
#ifdef LT_VARIANT_NO_LENGTHS
  const int incl_run = block_inclusive_sum(5 * r, sums);
#else
  const int incl_run = block_inclusive_sum(run_bits(tab, q, r), sums);
#endif
  const int bits = sums[kWarps - 1];
  if (tid < 32) {                           // 1 and 2
    if (tid == 0) publish(st + m, epoch, kAggregate, bits);
    int off = 0;
    for (int k0 = m + 1; k0 < M; k0 += 32) {
      const int k = k0 + lane;
      int v = 0;
      bool inclusive = true;                // past the row: nothing later
      if (k < M) {
        const unsigned long long x = await_status(st + k, epoch, kAggregate);
        v = status_value(x);
        inclusive = status_is(x, epoch, kInclusive);
      }
      const unsigned found = __ballot_sync(0xffffffffu, inclusive);
      if (found) {                          // the nearest inclusive total
        off += warp_sum(lane < __ffs(found) ? v : 0);
        break;
      }
      off += warp_sum(v);
    }
    if (tid == 0) {
      off_s = off;
      publish(st + m, epoch, kInclusive, off + bits);
    }
  }
  __syncthreads();                          // acc zeroed, off ready
  const int off = off_s, incl = off + bits;
  const int w0 = off >> 5, w1 = incl >> 5;
#ifndef LT_VARIANT_NO_PACK
  if (r > 0) pack_codes(acc, tab, q, r, (off & 31) + bits - incl_run);
#endif
  __syncthreads();                          // 3
  if (tid == 0) {
    ed[m] = acc[w1 - w0];
    publish(st + m, epoch, kEdge, incl);    // releases it
    first_s = (off & 31) && w0 < w1
                  ? gather_edges(st, ed, m + 1, M, w0, epoch) : 0u;
    top_s = m == 0 && (incl & 31)
                ? acc[w1 - w0] | gather_edges(st, ed, 1, M, w1, epoch) : 0u;
  }
  __syncthreads();                          // 4
  uint32_t* const out = words + (long long)s * row_words;
  for (int i = tid; i < w1 - w0; i += kThreads) {
    out[w0 + i] = i == 0 ? acc[0] | first_s : acc[i];
  }
  if (m == 0 && tid == 0) {
    if (w1 >= row_words) __trap();          // a row past its words
    if (incl & 31) out[w1] = top_s;
    totals[s] = incl;
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

// lits (n_rows, n_pad) u8, 16-byte aligned, n_pad a positive multiple
// of 16; n_lit (n_rows,) i32 (clamped to [0, n_pad]); table (256,) i32 =
// val | len << 16; work: a buffer of 8 + 12 x n_rows x M bytes (M =
// ceil(n_pad / kMaxLits)), zeroed once when it is made and kept across
// calls on one stream: its first word is the ticket counter, then the
// status words and the edge words of the pieces; zero_words: the words of
// a slice of a row's zeros; the call takes the tickets base to base +
// n_rows x (M + ceil(row_words / zero_words)), one block each; epoch: the
// call's number on this buffer, nonzero, below 2^31 and other than that
// of the calls that last wrote its statuses -> words (n_rows, row_words)
// u32, totals (n_rows,) i32
extern "C" int lt_hufpack_rows(const void* lits, const void* n_lit,
                               const void* table, void* words, void* totals,
                               void* work, int n_rows, int n_pad,
                               int row_words, int zero_words, unsigned epoch,
                               unsigned base, void* stream) {
  if (n_rows > 0 && n_pad > 0 && zero_words > 0) {
    const long long M = (n_pad + kMaxLits - 1) / kMaxLits;
    const long long Z = (row_words + zero_words - 1) / zero_words;
    unsigned long long* status = (unsigned long long*)work + 1;
    hufrows_kernel<<<(unsigned)(n_rows * (M + Z)), kThreads, 0,
                     (cudaStream_t)stream>>>(
        (const uint8_t*)lits, (const int32_t*)n_lit, (const int32_t*)table,
        (uint32_t*)words, (int32_t*)totals, (unsigned*)work, status,
        (uint32_t*)(status + n_rows * M), n_rows, n_pad, row_words,
        zero_words, epoch, base);
  }
  return (int)cudaGetLastError();
}
