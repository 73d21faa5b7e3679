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
//   Bound on the H100: the byte stream is read once (64 MiB per batch);
// the work per byte is a table lookup and ~6 integer operations plus one
// 32-bit modulo.  Design: one block of 256 threads per 4 KiB tile; the
// tile and its 47-byte halo are mapped through the 256-entry table into
// shared memory once, then each thread computes its first position's
// hash with all 48 taps and slides over 15 more positions with the
// recurrence h' = rotl(h,1) ^ rotl(T[out], 48 mod 32) ^ T[in].  The table
// values are stored with one padding word every 16 so that the threads'
// stride-16 reads fall into distinct banks.  A shared-memory tree merges
// the per-thread (min1, min2, cnt) of each segment.  Positions of a part
// before WINDOW-1 are masked, so a window never needs the previous
// part's bytes.
//   With a bins pointer the same launch also emits the fast compression
// tier's per-256-byte-bin anchor samples (device_match
// bin_mins_from_words; stage1.py _make_scan_kernel with_anchors): for
// every word w of the batch the 8-byte-gram hash of words w and w + 1 of
// the flat batch (0 after its last word), packed as (hash & ~63) |
// (w mod 64), and the minimum over each bin's 64 words.  Each thread
// takes 4 consecutive words (one 16-byte load, plus the next word, which
// for the tile's last thread lies in the next tile), and 16 threads
// reduce a bin with shuffles.  The Pallas kernel reads its tile's first
// word as the next word of the tile's last gram; this kernel follows the
// XLA definition instead.
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
constexpr int kTile = 4096;                 // bytes per scan block
constexpr int kScanThreads = 256;
constexpr int kRun = kTile / kScanThreads;  // consecutive positions per thread
constexpr int kHalo = kWindow - 1;
constexpr int kTv = kHalo + kTile;          // table values per block
constexpr int32_t kBig = 0x7fffffff;
constexpr int kBinWords = LT_BIN_WORDS;     // words per anchor bin
constexpr int kBinThreads = kBinWords / 4;  // threads per bin
static_assert(kTile % (4 * kBinWords) == 0 && kBinThreads <= 32 &&
                  (kBinThreads & (kBinThreads - 1)) == 0,
              "a bin is whole 4-word runs of one warp");

__device__ __forceinline__ int skew(int i) { return i + (i >> 4); }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);          // r taken mod 32
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const uint8_t* __restrict__ bytes,
            const int32_t* __restrict__ lengths,
            const uint32_t* __restrict__ table,
            int32_t* __restrict__ min1, int32_t* __restrict__ min2,
            int32_t* __restrict__ cnt, uint32_t* __restrict__ bins,
            int part_bytes, int z, uint32_t d) {
  __shared__ uint32_t tab[256];
  __shared__ uint32_t tv[kTv + kTv / 16 + 1];
  __shared__ int32_t r1[kScanThreads], r2[kScanThreads], rc[kScanThreads];

  const int tid = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * kTile;
  tab[tid] = table[tid];
  __syncthreads();

  // tv[i] = T[x[tile0 - kHalo + i]]; the tile itself is read as words
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bytes + tile0);
  for (int w = tid; w < kTile / 4; w += kScanThreads) {
    const uint32_t v = words[w];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      tv[skew(kHalo + 4 * w + k)] = tab[(v >> (8 * k)) & 0xffu];
    }
  }
  if (tid < kHalo) {
    const long long p = tile0 - kHalo + tid;
    tv[skew(tid)] = p >= 0 ? tab[bytes[p]] : 0u;
  }
  __syncthreads();

  const int part = (int)(tile0 / part_bytes);
  const int len = lengths[part];
  const int tile_in_part = (int)(tile0 - (long long)part * part_bytes);
  const int j0 = tid * kRun;

  uint32_t h = 0;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) h ^= rotl(tv[skew(j0 + kHalo - i)], i);

  int32_t m1 = kBig, m2 = kBig, c = 0;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int j = j0 + k;
    if (k > 0) {
      h = rotl(h, 1) ^ rotl(tv[skew(j - 1)], kWindow) ^ tv[skew(j + kHalo)];
    }
    const int pos_in_part = tile_in_part + j;
    if (h % d == d - 1u && pos_in_part >= kHalo && pos_in_part < len) {
      const int32_t e = (int32_t)(tile0 + j + 1);
      if (m1 == kBig) {
        m1 = e;
      } else if (m2 == kBig) {
        m2 = e;
      }
      ++c;
    }
  }

  // merge the (min1, min2, cnt) of the z / kRun threads of each segment
  r1[tid] = m1;
  r2[tid] = m2;
  rc[tid] = c;
  __syncthreads();
  const int group = z / kRun;
  for (int s = group / 2; s > 0; s >>= 1) {
    if ((tid & (group - 1)) < s) {
      const int32_t a1 = r1[tid], a2 = r2[tid];
      const int32_t b1 = r1[tid + s], b2 = r2[tid + s];
      r1[tid] = min(a1, b1);
      r2[tid] = min(max(a1, b1), min(a2, b2));
      rc[tid] += rc[tid + s];
    }
    __syncthreads();
  }
  if ((tid & (group - 1)) == 0) {
    const long long seg = (tile0 + j0) / z;
    min1[seg] = r1[tid];
    min2[seg] = r2[tid];
    cnt[seg] = rc[tid];
  }

  if (bins != nullptr) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(bytes);
    const long long w0 = tile0 / 4 + 4 * tid;   // this thread's first word
    const long long n_words = (long long)gridDim.x * (kTile / 4);
    const uint4 q = reinterpret_cast<const uint4*>(w + w0)[0];
    const uint32_t v[5] = {q.x, q.y, q.z, q.w,
                           w0 + 4 < n_words ? w[w0 + 4] : 0u};
    uint32_t best = 0xffffffffu;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t h = (v[k] * (uint32_t)LT_GRAM_H0) ^
                         ((v[k + 1] * (uint32_t)LT_GRAM_H1) >> 13) ^
                         (v[k + 1] << 7);
      const uint32_t packed = (h & ~(uint32_t)(kBinWords - 1)) |
                              (uint32_t)((4 * tid + k) & (kBinWords - 1));
      best = min(best, packed);
    }
#pragma unroll
    for (int o = kBinThreads / 2; o > 0; o >>= 1) {
      best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
    }
    if ((tid & (kBinThreads - 1)) == 0) {
      bins[tile0 / (4 * kBinWords) + tid / kBinThreads] = best;
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
std::atomic<bool> walk_smem_raised[kMaxDevices];  // per device, once

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

// bins: NULL, or (n_bytes / 256,) u32 anchor bin-mins
extern "C" int lt_stage1_scan(const void* bytes, const void* lengths,
                              const void* table, void* min1, void* min2,
                              void* cnt, void* bins, long long n_bytes,
                              int part_bytes, int z, uint32_t d,
                              void* stream) {
  const unsigned blocks = (unsigned)(n_bytes / kTile);
  scan_kernel<<<blocks, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const int32_t*)lengths,
      (const uint32_t*)table, (int32_t*)min1, (int32_t*)min2, (int32_t*)cnt,
      (uint32_t*)bins, part_bytes, z, d);
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
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !walk_smem_raised[dev].load()) {
    e = cudaFuncSetAttribute(walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWalkSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) walk_smem_raised[dev].store(true);
  }
  walk_kernel<<<(unsigned)n_parts, kWalkThreads, kWalkSmem,
                (cudaStream_t)stream>>>(
      (const int32_t*)lengths, (const int32_t*)min1, (const int32_t*)min2,
      (const int32_t*)cnt, (int32_t*)scratch32, (uint8_t*)scratch8,
      (int32_t*)out, part_bytes, seg_per_part, lgz, min_size, max_size,
      c_pad);
  return (int)cudaGetLastError();
}
