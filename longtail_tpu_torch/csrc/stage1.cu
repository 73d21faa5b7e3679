// Stage 1 of the chunk+hash data plane: the HPCDC candidate scan and the
// min/max cut walk over its per-segment summaries.
//
// lt_stage1_scan replaces longtail_tpu/parallel/stage1.py
// _make_scan_kernel (its inner `kernel`).  For every byte position p of a
// batch of B parts of part_bytes each it computes the 48-tap rolling hash
//   H(p) = XOR_{i<48} rotl32(T[x[p-i]], i mod 32)
// (longtail_tpu/ops/cdc.py), marks a candidate where H % d == d-1 and
// 47 <= p - part_start < length[part], and reduces the candidate ends
// (p + 1, absolute in the batch) of each Z-byte segment to
// (min1, min2, cnt): the two smallest ends and the count.
//   Bound on the H100: integer operations.  The byte stream is read once
// (64 MiB per batch, ~0.02 ms); the work per byte is the rolling update
// (two rotates and a 3-input xor) and the candidate test.  Design, per
// byte: 2 shared loads without bank conflicts, one address (a PRMT and an
// add, used again for the outgoing lookup 48 positions later), a rotate,
// a LOP3, an IMAD and half a 3-input min:
//  - Runs.  Each thread scans 256 consecutive bytes (kRun), read straight
//    from global memory as 16-byte words, and hashes the 48 bytes before
//    its run once (the warm-up, ~0.5 operations per byte of its run).
//    It then slides with h' = rotl(h, 1) ^ T16[out] ^ T[in], where T16 =
//    rotl(T, 48 mod 32) saves the outgoing byte's rotate.  The outgoing
//    bytes are the 16-byte word loaded three words earlier, kept in
//    registers.  A run is one anchor bin (4 * LT_BIN_WORDS bytes).
//  - Lookups.  Shared memory holds T and T16 in 32 copies, one per lane:
//    value v of lane l at word 64 v + l (T16 at + 32), 64 KiB.  Each lane
//    reads only its own bank, so no lookup conflicts; one PRMT builds the
//    address v * 256 + 4 l from the data word and the lane's offset.  A
//    block's thread v fills value v's 64 words, in an order that keeps a
//    warp's stores in distinct banks.
//  - The candidate test without a division.  h % d == d - 1 is (h + 1) % d
//    == 0.  With d = d0 * 2^s (d0 odd), inv = d0^-1 mod 2^32 and lim =
//    (2^32 - 1) / d (host constants, stage1.py scan_constants), n < 2^32
//    is a multiple of d iff r = rotr(n * inv, s) <= lim.  Per position:
//    one IMAD (h * inv + inv), a funnel shift where d is even (kRot) and
//    a running unsigned min of r; per 16 positions one compare of that
//    min against lim and a branch, taken only by the groups that hold a
//    candidate (~16 / d of them), to a loop that slides over the 16
//    positions again and records the candidates.  h = 2^32 - 1 (n wraps
//    to 0, r = 0) also takes the branch, but is a candidate only when d
//    is a power of two (inv = 1); the loop checks it.  The only division
//    is the part index, once per thread.
//  - Segments.  Z is a power of two in [128, 4096].  A thread writes the
//    summaries of the segments inside its run (Z <= 256); for Z > 256 the
//    Z / 256 threads of a segment (consecutive lanes of one warp) merge
//    with shuffles.  No shared-memory staging or merge tree.
// Positions of a part before WINDOW-1 are masked, so the bytes before a
// part's first run (the previous part's, or zeros before the batch) enter
// the warm-up and leave through the outgoing lookups without reaching a
// result.  Blocks are 256 threads (64 KiB of bytes); a batch need only be
// a multiple of 4096 bytes, and the threads of the last block past its end
// take no work.
//   With a bins pointer the same launch also emits the fast compression
// tier's per-256-byte-bin anchor samples (device_match
// bin_mins_from_words; stage1.py _make_scan_kernel with_anchors): for
// every word w of the batch the 8-byte-gram hash of words w and w + 1 of
// the flat batch (0 after its last word), packed as (hash & ~63) |
// (w mod 64), and the minimum over each bin's 64 words.  A thread's run
// is one bin, so it hashes the words it already holds, plus the first
// word of the next run.  The Pallas kernel reads its tile's first word as
// the next word of the tile's last gram; this kernel follows the XLA
// definition instead.
//
// lt_stage1_walk replaces stage1.py _make_walk_kernel.  It computes what
// the sequential min/max walk (Longtail_HPCDCNextChunk semantics) of
// stage1.py lane_step, and the port's walk_plain, compute over the
// segment summaries, bit for bit, without their per-part suffix-min.
//   Bound on the H100: min1 is read once (4 bytes per segment, 512 KiB
// per 64 MiB batch), min2 and cnt only in the sectors of the segments
// that hold a candidate (~4% of them), and the output written once:
// ~0.8 MB, ~0.25 us at 3.35 TB/s; the rest is integer control flow.  A
// sequential walk (one thread per part, this kernel's first design) is
// a chain of dependent global loads per cut (~0.24 us each, ~2,400
// cuts per 32 MiB part).  This design makes the walk parallel over the
// positions a cut can start from, one block of 1024 threads per part:
//  1. Compact.  The next cut after s depends on s alone, and each cut is
//     a summary candidate (min1/min2 of some segment, suf being the first
//     min1 of a later segment), s + max_size (forced) or the length.  The
//     block compacts 0 and every min1/min2 below kBig into a sorted list
//     of states (part-local ends), marking the min2 of each segment with 3+
//     candidates; "the first candidate end > q" of the summaries is then
//     the first list entry > q, and the ambiguity test looks at the last
//     entry <= q.  Warps take contiguous ranges of segments with 16
//     coalesced loads in flight per lane and compact with ballots.
//  2. One step per state, all states in parallel: the cuts the walk emits
//     from a state until it stops on the next state (or at the length),
//     with runs of forced cuts counted in closed form (k forced cuts of
//     max_size through a candidate-free stretch).
//  3. Path.  Pointer jumping from state 0 marks the states on the walk's
//     path in ~log2(path length) rounds (after round k the states at
//     distance < 2^k are marked); an exclusive scan of the marked states'
//     cut counts gives each its output index, and each writes its cuts,
//     stopping at c_pad as the sequential walk does.
//   The lists live in dynamic shared memory when a part has at most
// kWalkCap states (about 2,700 at the default geometry); a denser part
// (a small discriminator, content with a short period) runs the same code
// on global scratch, which the wrapper passes only where the geometry
// admits more than kWalkCap states per part.
// Output of the walk, per part b: out[b, 0:c_pad] = cut ends (0 past the
// cut count), out[b, c_pad] = n_chunks, out[b, c_pad + 1] = ambiguous.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#if !defined(LT_HPCDC_WINDOW) || !defined(LT_GRAM_H0) || !defined(LT_WALK_CAP)
#error "build through longtail_tpu_torch/_kernels.py, which defines the algorithm constants"
#endif

namespace {

constexpr int kWindow = LT_HPCDC_WINDOW;
constexpr int32_t kBig = 0x7fffffff;
constexpr int kBinWords = LT_BIN_WORDS;     // words per anchor bin
constexpr int kScanThreads = 256;
constexpr int kRun = 4 * kBinWords;         // bytes a thread scans: one bin
constexpr int kGroup = 16;                  // positions per 16-byte load
constexpr int kGroups = kRun / kGroup;
constexpr int kHaloGroups = kWindow / kGroup;   // loads the window spans
constexpr long long kScanTile = (long long)kScanThreads * kRun;
constexpr int kTabStride = 64;              // words per byte value: T x 32, T16 x 32
constexpr int kScanSmem = 256 * kTabStride * 4;
static_assert(kWindow % kGroup == 0 && kRun % kGroup == 0,
              "the window and a run are whole 16-byte loads");
static_assert(4096 % kRun == 0, "parts (stage1.py SCAN_TILE) are whole runs");
// Blocks per SM the scan is compiled for: its 64 KiB tables allow 3.
#ifndef LT_SCAN_BLOCKS_PER_SM
#define LT_SCAN_BLOCKS_PER_SM 3
#endif
// The experiments of tools/profile_torch_codecs.py --kernel-variants are
// builds with one of LT_VARIANT_NO_LOADS (the byte stream made in
// registers), LT_VARIANT_NO_LOOKUPS (the table lookups replaced by
// arithmetic) or LT_VARIANT_NO_FILL (the table fill skipped) defined, or
// another LT_SCAN_BLOCKS_PER_SM; each removes one part of the work and
// computes wrong results.  LT_VARIANT_ODD_FILTER keeps the results but
// filters on n * inv <= (lim << s) | (2^s - 1), which every multiple of
// d0 passes (~16 / d0 of the groups), without the funnel shift.  The
// library defines none.

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);          // r taken mod 32
}

// the lane's copy of the table entry of byte K of w: v * 256 + lane * 4
template <int K>
__device__ __forceinline__ uint32_t lookup(const uint32_t* tab, uint32_t w,
                                           uint32_t lane4) {
  const uint32_t off = __byte_perm(w, lane4, 0x5504u | (K << 4));
#ifdef LT_VARIANT_NO_LOOKUPS
  return off * 2654435761u + (uint32_t)(size_t)tab;
#else
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(tab) + off);
#endif
}

// the key whose running min over 16 positions is held against the filter
template <bool kRot>
__device__ __forceinline__ uint32_t filter_key(uint32_t n, int shift) {
  return kRot ? __funnelshift_r(n, n, shift) : n;
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// the anchor gram of word v and its successor, packed with its index
__device__ __forceinline__ uint32_t gram(uint32_t v, uint32_t next, int k) {
  const uint32_t h = (v * (uint32_t)LT_GRAM_H0) ^
                     ((next * (uint32_t)LT_GRAM_H1) >> 13) ^ (next << 7);
  return (h & ~(uint32_t)(kBinWords - 1)) | (uint32_t)(k & (kBinWords - 1));
}

struct Summary {
  int32_t m1 = kBig, m2 = kBig, c = 0;
  __device__ void add(int32_t e) {          // ends arrive in order
    if (m1 == kBig) {
      m1 = e;
    } else if (m2 == kBig) {
      m2 = e;
    }
    ++c;
  }
  __device__ void merge(int32_t b1, int32_t b2, int32_t bc) {
    const int32_t a1 = m1, a2 = m2;
    m1 = min(a1, b1);
    m2 = min(max(a1, b1), min(a2, b2));
    c += bc;
  }
  __device__ void store(int32_t* min1, int32_t* min2, int32_t* cnt,
                        long long seg) const {
    min1[seg] = m1;
    min2[seg] = m2;
    cnt[seg] = c;
  }
};

template <bool kBins, bool kRot>
__global__ void __launch_bounds__(kScanThreads, LT_SCAN_BLOCKS_PER_SM)
scan_kernel(const uint8_t* __restrict__ bytes, long long n_bytes,
            const int32_t* __restrict__ lengths,
            const uint32_t* __restrict__ table,
            int32_t* __restrict__ min1, int32_t* __restrict__ min2,
            int32_t* __restrict__ cnt, uint32_t* __restrict__ bins,
            int part_bytes, int lgz, uint32_t inv, uint32_t lim,
            int shift) {
#ifdef LT_VARIANT_ODD_FILTER
  const uint32_t filt = kRot ? lim : (lim << shift) | ((1u << shift) - 1u);
#else
  const uint32_t filt = lim;                // exact: kRot wherever shift > 0
#endif
  extern __shared__ uint32_t scan_tab[];
  const int tid = threadIdx.x;
  const uint32_t lane4 = (uint32_t)(tid & 31) * 4u;
  {
    // thread v writes value v's 64 words, lane copy (j + v) mod 32 at
    // step j, so that a warp's stores fall into 32 distinct banks
    static_assert(kScanThreads == 256, "one thread per table value");
    const uint32_t t = __ldg(table + tid), t16 = rotl(t, kWindow);
    uint32_t* row = scan_tab + tid * kTabStride;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + tid) & 31;
#ifdef LT_VARIANT_NO_FILL
      if (t == 1u) row[c] = t16;
#else
      row[c] = t;
      row[32 + c] = t16;
#endif
    }
  }
  __syncthreads();

  const long long start = blockIdx.x * kScanTile + (long long)tid * kRun;
  const bool live = start < n_bytes;        // the last block may be partial
  const int z = 1 << lgz;
  Summary s;
  if (live) {
    const int part = (int)(start / part_bytes);
    const int len = lengths[part];
    const int pos0 = (int)(start - (long long)part * part_bytes);
    const uint4* src = reinterpret_cast<const uint4*>(bytes + start);
    // ring[k & 3] holds load k of the run; k = -3..-1 are the window's
    // bytes before it (zeros before the batch)
    uint4 ring[4];
#pragma unroll
    for (int k = -kHaloGroups; k < 0; ++k) {
      ring[k & 3] = start > 0 ? src[k] : make_uint4(0u, 0u, 0u, 0u);
    }
    // warm-up: h = H(start - 1) = XOR_i rotl(T[x[start - 1 - i]], i)
    uint32_t h = 0;
#pragma unroll
    for (int k = -kHaloGroups; k < 0; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w = word_of(ring[k & 3], q);
        const int at = -kGroup * k - 4 * q - 1;   // start - 1 - its position
        h ^= rotl(lookup<0>(scan_tab, w, lane4), at) ^
             rotl(lookup<1>(scan_tab, w, lane4), at - 1) ^
             rotl(lookup<2>(scan_tab, w, lane4), at - 2) ^
             rotl(lookup<3>(scan_tab, w, lane4), at - 3);
      }
    }
    uint32_t best = 0xffffffffu, prev = 0u;
    uint4 next = src[0];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint4 cur = next;
#ifdef LT_VARIANT_NO_LOADS
      next = make_uint4(cur.x * 747796405u + g, cur.y ^ cur.x, cur.z + cur.y,
                        cur.w ^ cur.z);
#else
      if (g + 1 < kGroups) next = src[g + 1];
#endif
      const uint4 out = ring[(g - kHaloGroups) & 3];
      const uint32_t h0 = h;
      // n = (h + 1) * inv; the min of its key over the 16 positions
      // against filt lets through every group with a multiple of d
      uint32_t nmin = 0xffffffffu;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t wi = word_of(cur, q), wo = word_of(out, q);
#define LT_SCAN_STEP(K)                                                  \
  h = rotl(h, 1) ^ lookup<K>(scan_tab + 32, wo, lane4) ^                 \
      lookup<K>(scan_tab, wi, lane4);                                    \
  nmin = min(nmin, filter_key<kRot>(h * inv + inv, shift));
        LT_SCAN_STEP(0)
        LT_SCAN_STEP(1)
        LT_SCAN_STEP(2)
        LT_SCAN_STEP(3)
#undef LT_SCAN_STEP
        if (kBins) {
          const int k = 4 * g + q;          // word index in the run
          if (k > 0) best = min(best, gram(prev, wi, k - 1));
          prev = wi;
        }
      }
      if (nmin <= filt) {
        // rare: slide again from h0, one position at a time, with the
        // exact test
        uint32_t hh = h0;
#pragma unroll 1
        for (int k = 0; k < kGroup; ++k) {
          const int sh = 8 * (k & 3);
          const uint32_t vi = (word_of(cur, k >> 2) >> sh) & 0xffu;
          const uint32_t vo = (word_of(out, k >> 2) >> sh) & 0xffu;
          hh = rotl(hh, 1) ^ scan_tab[vo * kTabStride + 32 + (lane4 >> 2)] ^
               scan_tab[vi * kTabStride + (lane4 >> 2)];
          const uint32_t n = hh * inv + inv;
          const uint32_t r = __funnelshift_r(n, n, shift);
          const int p = pos0 + kGroup * g + k;
          if (r <= lim && (r != 0u || inv == 1u) && p >= kWindow - 1 &&
              p < len) {
            s.add((int32_t)(start + kGroup * g + k + 1));
          }
        }
      }
      ring[g & 3] = cur;
      if (z <= kRun && ((kGroup * (g + 1)) & (z - 1)) == 0) {
        s.store(min1, min2, cnt, ((start + kGroup * (g + 1)) >> lgz) - 1);
        s = Summary();
      }
    }
    if (kBins) {
      const long long after = start + kRun;
      const uint32_t nxt =
          after < n_bytes ? *reinterpret_cast<const uint32_t*>(bytes + after)
                          : 0u;
      best = min(best, gram(prev, nxt, kBinWords - 1));
      bins[start / kRun] = best;
    }
  }
  if (z > kRun) {
    // the z / kRun threads of a segment are consecutive lanes of one warp
    for (int o = z / kRun / 2; o > 0; o >>= 1) {
      s.merge(__shfl_xor_sync(0xffffffffu, s.m1, o),
              __shfl_xor_sync(0xffffffffu, s.m2, o),
              __shfl_xor_sync(0xffffffffu, s.c, o));
    }
    if (live && (start & (z - 1)) == 0) {
      s.store(min1, min2, cnt, start >> lgz);
    }
  }
}

constexpr int kWalkThreads = 1024;
constexpr int kWalkUnroll = 16;             // summary loads in flight per lane
constexpr int kWalkCap = LT_WALK_CAP;       // states a part keeps in shared memory
constexpr int kWalkSmem = kWalkCap * 17;    // V, J0, J1, C (4 bytes), M (1 byte)
constexpr uint32_t kPos = 0x7fffffffu;      // a state's part-local end
constexpr uint32_t kAmbFlag = 0x80000000u;  // the min2 of a segment with 3+ candidates
static_assert(kWalkSmem + 1024 <= 232448, "shared memory of one block");
constexpr int kMaxDevices = 64;
// the dynamic shared-memory attribute, set once per device and kernel
std::atomic<bool> walk_smem_raised[kMaxDevices];
std::atomic<bool> scan_smem_raised[4][kMaxDevices];

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return e;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct WalkPart {
  const uint32_t* v;  // sorted states; index n is the terminal
  int n, len, mn, mx, lgz, last_seg;
};

// The cuts the walk emits from state i until it stops on a state: returns
// that state (n once the part's length is reached) and sets *count.  With
// ends, the cuts go to ends[o + k] while o + k < c_pad, and the ambiguity
// test of the queries behind them is ORed into *amb.
__device__ int walk_step(const WalkPart& w, int i, int* count, int32_t* ends,
                         int o, int c_pad, int* amb) {
  int s = (int)(w.v[i] & kPos);
  *count = 0;
  if (s >= w.len) return w.n;
  int lo = i + 1, hi = w.n;                 // the first state > s + min_size
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int)(w.v[mid] & kPos) <= s + w.mn) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int j = lo, emitted = 0;
  for (;;) {
    const int q = s + w.mn;                 // first admissible end is > q
    while (j < w.n && (int)(w.v[j] & kPos) <= q) ++j;
    // lane_step's test: the queried segment holds 3+ candidates and both
    // kept ends are <= q, i.e. the last state <= q is its flagged min2
    const uint32_t prev = w.v[j - 1];
    const int a = (prev & kAmbFlag) != 0 &&
                  (int)(((prev & kPos) - 1u) >> w.lgz) ==
                      min(q >> w.lgz, w.last_seg);
    const int rem = w.len - s;
    const int v = j < w.n ? (int)(w.v[j] & kPos) : kBig;
    const int limit = rem > w.mx ? s + w.mx : w.len;
    int e = w.len, next = w.n, k = 0;       // one cut e, or k forced cuts
    if (rem > w.mn && v <= limit) {
      e = v;
      next = j;
    } else if (rem > w.mn && limit < w.len) {
      // forced cuts s + mx, ..., s + k mx while the next state stays
      // beyond reach and more than max_size remains
      k = (min(v, w.len) - s - 1) / w.mx;
    }
    const int at = o + emitted;
    if (ends != nullptr && at < c_pad) {
      *amb |= a;
      if (k == 0) {
        ends[at] = e;
      } else {
        for (int t = 1; t <= k && at + t <= c_pad; ++t) {
          ends[at + t - 1] = s + t * w.mx;
        }
      }
    }
    if (k == 0) {
      *count = emitted + 1;
      return next;
    }
    emitted += k;
    s += k * w.mx;
    if (ends != nullptr && o + emitted >= c_pad) {
      *count = emitted;
      return w.n;
    }
  }
}

__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const int32_t* __restrict__ lengths,
            const int32_t* __restrict__ min1,
            const int32_t* __restrict__ min2,
            const int32_t* __restrict__ cnt, int32_t* scratch32,
            uint8_t* scratch8, int32_t* __restrict__ out, int part_bytes,
            int seg_per_part, int lgz, int min_size, int max_size,
            int c_pad) {
  extern __shared__ __align__(16) uint8_t walk_smem[];
  __shared__ int warp_tot[32];

  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, n_warps = nt >> 5;
  const int b = blockIdx.x;
  const int off = b * part_bytes;           // part start in the batch
  const int32_t* m1p = min1 + (long long)b * seg_per_part;
  const int32_t* m2p = min2 + (long long)b * seg_per_part;
  const int32_t* cnp = cnt + (long long)b * seg_per_part;

  // 1. compact: warp w takes the segments [lo, hi), 32 x kWalkUnroll at a
  // time; pass one counts the states, pass two writes them in order
  const int per_warp = (seg_per_part + n_warps - 1) / n_warps;
  const int lo = min(warp * per_warp, seg_per_part);
  const int hi = min(lo + per_warp, seg_per_part);
  int32_t m1[kWalkUnroll], m2[kWalkUnroll];
  int mine = 0;
  for (int base = lo; base < hi; base += 32 * kWalkUnroll) {
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      const int g = base + 32 * u + lane;
      m1[u] = g < hi ? m1p[g] : kBig;
    }
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      m2[u] = m1[u] != kBig ? m2p[base + 32 * u + lane] : kBig;
      mine += (m1[u] != kBig) + (m2[u] != kBig);
    }
  }
  mine = warp_sum(mine);
  if (lane == 0) warp_tot[warp] = mine;
  __syncthreads();
  int before = 0, total = 0;
  for (int x = 0; x < n_warps; ++x) {
    before += x < warp ? warp_tot[x] : 0;
    total += warp_tot[x];
  }
  const int n = 1 + total;                  // state 0 is the part's start

  uint32_t* V;
  int32_t *J0, *J1, *C;
  uint8_t* M;
  if (n + 1 <= kWalkCap) {
    V = reinterpret_cast<uint32_t*>(walk_smem);
    J0 = reinterpret_cast<int32_t*>(V + kWalkCap);
    J1 = J0 + kWalkCap;
    C = J1 + kWalkCap;
    M = reinterpret_cast<uint8_t*>(C + kWalkCap);
  } else {
    const long long stride = 2LL * seg_per_part + 2;
    V = reinterpret_cast<uint32_t*>(scratch32 + 4 * stride * b);
    J0 = reinterpret_cast<int32_t*>(V + stride);
    J1 = J0 + stride;
    C = J1 + stride;
    M = scratch8 + stride * b;
  }

  const unsigned lower = (1u << lane) - 1u;
  int at = 1 + before;
  for (int base = lo; base < hi; base += 32 * kWalkUnroll) {
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      const int g = base + 32 * u + lane;
      m1[u] = g < hi ? m1p[g] : kBig;
    }
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      m2[u] = m1[u] != kBig ? m2p[base + 32 * u + lane] : kBig;
    }
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      const unsigned b1 = __ballot_sync(full, m1[u] != kBig);
      const unsigned b2 = __ballot_sync(full, m2[u] != kBig);
      const int pos = at + __popc(b1 & lower) + __popc(b2 & lower);
      if (m1[u] != kBig) V[pos] = (uint32_t)(m1[u] - off);
      if (m2[u] != kBig) {
        const bool amb3 = cnp[base + 32 * u + lane] >= 3;
        V[pos + 1] = (uint32_t)(m2[u] - off) | (amb3 ? kAmbFlag : 0u);
      }
      at += __popc(b1) + __popc(b2);
    }
  }
  if (tid == 0) V[0] = 0u;
  __syncthreads();

  // 2. every state's step: J0 = the next state, C = its cuts
  const WalkPart w{V, n, lengths[b], min_size, max_size, lgz,
                   seg_per_part - 1};
  for (int i = tid; i <= n; i += nt) {
    int c = 0;
    J0[i] = i < n ? walk_step(w, i, &c, nullptr, 0, 0, nullptr) : n;
    C[i] = c;
    M[i] = i == 0;
  }
  __syncthreads();

  // 3. mark the path of state 0: before a round with cur = next^(2^r), the
  // states at distance < 2^r are marked; it marks those below 2^(r+1).
  // A mark read late only delays a mark of the same path (marks are never
  // wrong), so the rounds need no other ordering.
  int32_t* cur = J0;
  int32_t* nxt = J1;
  while (cur[0] != n) {
    for (int i = tid; i <= n; i += nt) {
      const int32_t j = cur[i];
      if (M[i]) M[j] = 1;
      nxt[i] = cur[j];
    }
    __syncthreads();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // 4. output index of each marked state (exclusive scan of C over the
  // marked states, in order: the path's states increase), then its cuts
  const int per = (n + nt - 1) / nt;
  const int i0 = min(tid * per, n), i1 = min(i0 + per, n);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += M[i] ? C[i] : 0;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int o = incl - sum, cuts = 0;
  for (int x = 0; x < n_warps; ++x) {
    o += x < warp ? warp_tot[x] : 0;
    cuts += warp_tot[x];
  }
  int32_t* ends = out + (long long)b * (c_pad + 2);
  int amb = 0;
  for (int i = i0; i < i1 && o < c_pad; ++i) {
    if (M[i] && C[i] > 0) {
      int c;
      walk_step(w, i, &c, ends, o, c_pad, &amb);
      o += C[i];
    }
  }
  const int n_chunks = min(cuts, c_pad);
  for (int i = n_chunks + tid; i < c_pad; i += nt) ends[i] = 0;
  amb = __syncthreads_or(amb);
  if (tid == 0) {
    ends[c_pad] = n_chunks;
    ends[c_pad + 1] = amb;
  }
}

}  // namespace

// bins: NULL, or (n_bytes / 256,) u32 anchor bin-mins.  n_bytes and
// part_bytes are multiples of 4096, bytes 16-byte aligned; inv, lim and
// shift are stage1.py scan_constants(d).
extern "C" int lt_stage1_scan(const void* bytes, const void* lengths,
                              const void* table, void* min1, void* min2,
                              void* cnt, void* bins, long long n_bytes,
                              int part_bytes, int lgz, uint32_t inv,
                              uint32_t lim, int shift, void* stream) {
  const bool with_bins = bins != nullptr;
#ifdef LT_VARIANT_ODD_FILTER
  const bool rot = false;
#else
  const bool rot = shift != 0;
#endif
  const int variant = 2 * (int)with_bins + (int)rot;
  decltype(&scan_kernel<false, false>) const kernels[4] = {
      scan_kernel<false, false>, scan_kernel<false, true>,
      scan_kernel<true, false>, scan_kernel<true, true>};
  const auto kernel = kernels[variant];
  const cudaError_t e =
      raise_smem(kernel, kScanSmem, scan_smem_raised[variant]);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((n_bytes + kScanTile - 1) / kScanTile);
  kernel<<<blocks, kScanThreads, kScanSmem, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, n_bytes, (const int32_t*)lengths,
      (const uint32_t*)table, (int32_t*)min1, (int32_t*)min2, (int32_t*)cnt,
      (uint32_t*)bins, part_bytes, lgz, inv, lim, shift);
  return (int)cudaGetLastError();
}

// scratch32 / scratch8: the global fallback of a dense part, n_parts x
// walk_stride int32 x 4 and u8 x 1 (stage1.py walk_scratch), or NULL
// where 2 * seg_per_part + 2 <= kWalkCap
extern "C" int lt_stage1_walk(const void* lengths, const void* min1,
                              const void* min2, const void* cnt,
                              void* scratch32, void* scratch8, void* out,
                              int n_parts, int part_bytes, int seg_per_part,
                              int lgz, int min_size, int max_size, int c_pad,
                              void* stream) {
  const cudaError_t e = raise_smem(walk_kernel, kWalkSmem, walk_smem_raised);
  if (e != cudaSuccess) return (int)e;
  walk_kernel<<<(unsigned)n_parts, kWalkThreads, kWalkSmem,
                (cudaStream_t)stream>>>(
      (const int32_t*)lengths, (const int32_t*)min1, (const int32_t*)min2,
      (const int32_t*)cnt, (int32_t*)scratch32, (uint8_t*)scratch8,
      (int32_t*)out, part_bytes, seg_per_part, lgz, min_size, max_size,
      c_pad);
  return (int)cudaGetLastError();
}
