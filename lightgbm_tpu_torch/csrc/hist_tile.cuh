// Device code of the segment histogram, shared by the per-phase kernel
// (hist_segment.cu) and the fused split step (split_step_segment.cu),
// so both sum every bin in the same order and agree bit for bit.
//
// hist_rows accumulates rows of a segment into a block's
// shared-memory histogram [nf][B][3] (sum grad, sum hess, count) of
// features f0 .. f0 + nf. Tiles of 256 rows: each thread decodes one
// row's grad, hess and count into shared memory, then warp w owns
// features w, w + 8, ... exclusively. For one feature and 32 rows,
// __match_any_sync groups the lanes that hit the same bin; the lowest
// lane sums its peers' values in lane order and adds the sum to the
// shared bin. The summation order of every bin is therefore fixed by
// the row order alone.
#pragma once

#include "common.cuh"

namespace ltt {

constexpr int kHistThreads = 256;  // threads per histogram block
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kTileRows = 256;     // must match TILE_ROWS in hist_cuda.py

// shared floats a block needs: [feat_tile][B][3] bins + 3 x kTileRows
__host__ __device__ constexpr size_t hist_smem_floats(int feat_tile,
                                                      int num_bins) {
  return (size_t)feat_tile * num_bins * 3 + 3 * kTileRows;
}

// Rows [begin + r0, begin + r1) of the matrix. kNonCoherent reads the
// bins through the read-only cache; only for a matrix nothing writes
// during the kernel. The caller zeroes hist_s and synchronises the block
// first. The tile address is formed from (mat, begin + t0) as one
// product: that keeps the loop's index arithmetic on the uniform
// datapath. With the segment's base pointer passed in instead, nvcc
// moved it to per-thread registers and the per-phase kernel took 20%
// longer in full-width training on an H100 (chip_profile.py).
template <bool kNonCoherent>
__device__ __forceinline__ void hist_rows(const uint8_t* mat,
                                          long long begin, int stride,
                                          int pay_off, long long r0,
                                          long long r1, int f0, int nf,
                                          int num_bins, float* hist_s,
                                          float* stage) {
  float* g_s = stage;  // [kTileRows] each
  float* h_s = g_s + kTileRows;
  float* c_s = h_s + kTileRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (long long t0 = r0; t0 < r1; t0 += kTileRows) {
    const int nrows = (int)min((long long)kTileRows, r1 - t0);
    const uint8_t* tile = mat + (size_t)(begin + t0) * stride;
    if (threadIdx.x < nrows) {
      const uint8_t* row = tile + (size_t)threadIdx.x * stride + pay_off;
      g_s[threadIdx.x] = *reinterpret_cast<const float*>(row + LTT_G_OFF);
      h_s[threadIdx.x] = *reinterpret_cast<const float*>(row + LTT_H_OFF);
      c_s[threadIdx.x] = (float)row[LTT_CNT_OFF];
    }
    __syncthreads();
    for (int fl = warp; fl < nf; fl += kHistWarps) {
      float* hf = hist_s + (size_t)fl * num_bins * 3;
      const uint8_t* col = tile + f0 + fl;
      for (int base = 0; base < nrows; base += 32) {
        const int r = base + lane;
        const bool valid = r < nrows;
        const int bin = valid ? (kNonCoherent
                                     ? (int)__ldg(col + (size_t)r * stride)
                                     : (int)col[(size_t)r * stride])
                              : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (valid && lane == __ffs(peers) - 1) {
          float sg = 0.f, sh = 0.f, sc = 0.f;
          unsigned m = peers;
          while (m) {
            const int p = base + __ffs(m) - 1;
            m &= m - 1;
            sg += g_s[p];
            sh += h_s[p];
            sc += c_s[p];
          }
          hf[bin * 3 + 0] += sg;
          hf[bin * 3 + 1] += sh;
          hf[bin * 3 + 2] += sc;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace ltt
