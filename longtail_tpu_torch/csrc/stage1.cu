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
// lt_stage1_walk replaces stage1.py _make_walk_kernel.  It runs the
// sequential min/max walk (Longtail_HPCDCNextChunk semantics) of
// stage1.py lane_step, one thread per part, over the segment summaries
// and their per-part exclusive suffix-min `suf`.  A lane is flagged
// ambiguous when a segment it consults holds 3+ candidates and both kept
// ends precede the query; the host re-chunks such a lane exactly.
//   Bound on the H100: latency.  Each cut is a chain of four dependent
// global loads, and there are only B threads (2 at the default geometry),
// so the walk takes ~(cuts per part) x (load latency).  Making it
// parallel is later work.
//
// Output of the walk, per part b: out[b, 0:c_pad] = cut ends (0 past the
// cut count), out[b, c_pad] = n_chunks, out[b, c_pad + 1] = ambiguous.

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(LT_HPCDC_WINDOW) || !defined(LT_GRAM_H0)
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

__global__ void walk_kernel(const int32_t* __restrict__ lengths,
                            const int32_t* __restrict__ min1,
                            const int32_t* __restrict__ min2,
                            const int32_t* __restrict__ cnt,
                            const int32_t* __restrict__ suf,
                            int32_t* __restrict__ out, int n_parts,
                            int part_bytes, int seg_per_part, int lgz,
                            int min_size, int max_size, int c_pad) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_parts) return;
  int32_t* ends = out + (long long)b * (c_pad + 2);
  const int len = lengths[b];
  const int off = b * part_bytes;           // part start in the batch
  const long long seg0 = (long long)b * seg_per_part;
  int s = 0, n = 0, amb = 0;
  while (s < len && n < c_pad) {
    const int q = s + min_size;             // first admissible end is > q
    const int t = min(q >> lgz, seg_per_part - 1);
    const long long g = seg0 + t;
    const int qa = q + off;
    const int32_t m1 = min1[g], m2 = min2[g], cn = cnt[g], sf = suf[g];
    const int32_t in_seg = m1 > qa ? m1 : (m2 > qa ? m2 : kBig);
    amb |= (cn >= 3) & (m2 <= qa) & (m1 <= qa);
    const int e_cand = min(in_seg, sf) - off;
    const int rem = len - s;
    const int limit = rem > max_size ? s + max_size : len;
    int e = min(e_cand > q ? e_cand : limit, limit);
    if (rem <= min_size) e = len;
    ends[n++] = e;
    s = e;
  }
  for (int i = n; i < c_pad; ++i) ends[i] = 0;
  ends[c_pad] = n;
  ends[c_pad + 1] = amb;
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

extern "C" int lt_stage1_walk(const void* lengths, const void* min1,
                              const void* min2, const void* cnt,
                              const void* suf, void* out, int n_parts,
                              int part_bytes, int seg_per_part, int lgz,
                              int min_size, int max_size, int c_pad,
                              void* stream) {
  const int threads = 32;
  const unsigned blocks = (unsigned)((n_parts + threads - 1) / threads);
  walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lengths, (const int32_t*)min1, (const int32_t*)min2,
      (const int32_t*)cnt, (const int32_t*)suf, (int32_t*)out, n_parts,
      part_bytes, seg_per_part, lgz, min_size, max_size, c_pad);
  return (int)cudaGetLastError();
}
