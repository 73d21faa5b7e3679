// Chunk pack: copy each chunk's bytes, from any byte offset of the
// device-resident batch, into an aligned row of little-endian u32 words,
// zeroing every byte at or past the chunk's size.
//
// Replaces longtail_tpu/parallel/pipeline.py _pack_callable (its
// `pack_kernel`).  The TPU kernel DMAs a 4 KiB-aligned window per row and
// undoes the misalignment with lane/sublane rotates; a GPU reads global
// memory at any word, so here output word j of a row is one funnel shift
// of the batch words start/4 + j and start/4 + j + 1.
//   Bound on the H100: memory bandwidth (each row is read once and
// written once, the neighbouring word comes from L1).  Design: one block
// per chunk row, its threads striding over the row's words so that a
// warp reads and writes consecutive words.  Reads are bounds-checked
// against the batch, so the batch needs no slack words; rows of size 0
// (padding) are written as zeros.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const uint32_t* __restrict__ words, long long n_words,
            const int32_t* __restrict__ starts,
            const int32_t* __restrict__ sizes, uint32_t* __restrict__ out,
            int row_words) {
  const int row = blockIdx.x;
  const int start = starts[row];
  const int size = sizes[row];
  const long long w0 = start >> 2;
  const int shift = (start & 3) * 8;
  uint32_t* dst = out + (long long)row * row_words;
  for (int j = threadIdx.x; j < row_words; j += kPackThreads) {
    const int nb = size - 4 * j;            // chunk bytes in this word
    uint32_t v = 0;
    if (nb > 0) {
      const long long w = w0 + j;
      const uint32_t lo = w < n_words ? words[w] : 0u;
      const uint32_t hi = w + 1 < n_words ? words[w + 1] : 0u;
      v = __funnelshift_r(lo, hi, shift);
      if (nb < 4) v &= (1u << (8 * nb)) - 1u;
    }
    dst[j] = v;
  }
}

}  // namespace

extern "C" int lt_pack(const void* words, long long n_words,
                       const void* starts, const void* sizes, void* out,
                       int rows, int row_words, void* stream) {
  pack_kernel<<<(unsigned)rows, kPackThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (const int32_t*)starts,
      (const int32_t*)sizes, (uint32_t*)out, row_words);
  return (int)cudaGetLastError();
}
