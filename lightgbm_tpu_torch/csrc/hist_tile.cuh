// Device code of the segment histogram, shared by the per-phase kernel
// (hist_segment.cu) and the fused split step (split_step_segment.cu),
// so both sum every bin in the same order and agree bit for bit.
//
// Features go in tiles of kTileFeatures, one feature a warp: a block
// sums one (chunk, feature tile). The chunk rule: a segment of `count`
// rows is cut into child_chunks(count, F) contiguous chunks of
// ceil(count / chunks) rows, kChunkRows rows a chunk and at most
// max_chunks(F) chunks, so that chunks x feature tiles stays within
// kChunkSlots (264 = the resident grid of the fused step on an H100,
// and the leading dimension of the partial buffers both kernels write).
// The rule sees the row count and the feature count alone: not the
// grid, not the card. Each chunk's histogram is summed in float64 in row order
// (below), the chunks' float64 partials are summed in chunk order and
// the total is rounded once to float32, as the plain version
// (hist_cuda.histogram_segment_plain) accumulates in float64 and rounds
// once. So a bin's sum depends on the segment's rows and their order
// only, and equals the plain version's but where the two float64 sums
// straddle a float32 rounding boundary.
//
// hist_rows accumulates rows [r0, r1) of a segment (one chunk) into a
// block's float64 shared-memory histogram [nf][B][3] (sum grad, sum
// hess, count) of features f0 .. f0 + nf. Steps of 256 rows: each thread
// loads one row's grad, hess, count and the tile's bins into registers
// (the next step's loads are in flight while the current step is
// accumulated), then stores them to shared memory, the bins transposed
// to [feature][row]. Warp w owns feature f0 + w.
// For one feature and a 32-row group, __match_any_sync groups the lanes
// that hit the same bin; the lowest lane sums its peers' values in lane
// order (in float64) and adds the sum to the shared bin. kGroups groups
// are matched and summed together; their adds land group by group. The
// summation order of every bin is therefore fixed by the row order
// within the chunk alone.
#pragma once

#include "common.cuh"

namespace ltt {

constexpr int kHistThreads = 256;  // threads per histogram block
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kStepRows = kHistThreads;  // rows per staged step
constexpr int kTileFeatures = kHistWarps;  // hist_cuda.TILE_FEATURES
constexpr int kTileWords = kTileFeatures / 4;
constexpr int kChunkRows = 256;    // hist_cuda.CHUNK_ROWS
constexpr int kChunkSlots = 264;   // hist_cuda.CHUNK_SLOTS
constexpr int kGroups = 4;         // 32-row groups a warp has in flight

__host__ __device__ inline int feature_tiles(int num_features) {
  return (num_features + kTileFeatures - 1) / kTileFeatures;
}

// The most chunks of a segment (the partial buffers' leading dimension).
__host__ __device__ inline int max_chunks(int num_features) {
  const int c = kChunkSlots / feature_tiles(num_features);
  return c < 1 ? 1 : c;
}

// The chunks of a segment of `count` rows (see the note above).
__host__ __device__ inline int child_chunks(long long count,
                                            int num_features) {
  const long long c = (count + kChunkRows - 1) / kChunkRows;
  const int cap = max_chunks(num_features);
  return (int)(c < 1 ? 1 : (c > cap ? cap : c));
}

// shared bytes a block needs: [kTileFeatures][B][3] f64 bins, the staged
// rows' grad/hess/count (f32) and bins (u8, [kTileFeatures][kStepRows])
__host__ __device__ constexpr size_t hist_smem_bytes(int num_bins) {
  return (size_t)kTileFeatures * num_bins * 24 + 3 * kStepRows * 4 +
         (size_t)kTileFeatures * kStepRows;
}

// One thread's staged row: grad, hess, count and the tile's bins, four
// to a word.
struct StagedRow {
  float g, h, c;
  unsigned w[kTileWords];
};

// kL2: the rows were written by another block of this launch (read from
// L2); otherwise nothing writes them during the kernel (read-only path).
template <bool kL2>
__device__ __forceinline__ unsigned load_word(const uint8_t* p) {
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
  return kL2 ? __ldcg(q) : __ldg(q);
}

// The calling thread's row of the step starting at `tile` (one product
// (begin + t0) * stride, formed by the caller: that keeps the index
// arithmetic on the uniform datapath; with the segment's base pointer
// passed in instead, nvcc moved it to per-thread registers and the
// per-phase kernel took 20% longer in full-width training on an H100,
// chip_profile.py). f0 is a multiple of 4.
template <bool kL2>
__device__ __forceinline__ void load_row(const uint8_t* tile, int stride,
                                         int pay_off, int f0, int nf,
                                         StagedRow& st) {
  const uint8_t* row = tile + (size_t)threadIdx.x * stride;
  st.g = __uint_as_float(load_word<kL2>(row + pay_off + LTT_G_OFF));
  st.h = __uint_as_float(load_word<kL2>(row + pay_off + LTT_H_OFF));
  st.c = (float)(load_word<kL2>(row + pay_off + LTT_CNT_OFF) & 0xffu);
#pragma unroll
  for (int i = 0; i < kTileWords; ++i)
    if (4 * i < nf) st.w[i] = load_word<kL2>(row + f0 + 4 * i);
}

// One warp adds kGroups consecutive 32-row groups (from base; m rows
// staged) of one feature's staged bins bs into its shared bins hf.
__device__ __forceinline__ void add_groups(const uint8_t* bs, int base,
                                           int m, int lane, const float* g_s,
                                           const float* h_s, const float* c_s,
                                           double* hf) {
  int bin[kGroups];
  unsigned peers[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int j = base + 32 * q + lane;
    bin[q] = j < m ? (int)bs[j] : -1;
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q)
    peers[q] = __match_any_sync(0xffffffffu, bin[q]);
  double sg[kGroups], sh[kGroups], sc[kGroups];
  bool lead[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    lead[q] = bin[q] >= 0 && lane == __ffs(peers[q]) - 1;
    double g = 0.0, h = 0.0, c = 0.0;
    if (lead[q]) {
      unsigned mm = peers[q];
      while (mm) {
        const int p = base + 32 * q + __ffs(mm) - 1;
        mm &= mm - 1;
        g += (double)g_s[p];
        h += (double)h_s[p];
        c += (double)c_s[p];
      }
    }
    sg[q] = g;
    sh[q] = h;
    sc[q] = c;
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (lead[q]) {
      hf[bin[q] * 3 + 0] += sg[q];
      hf[bin[q] * 3 + 1] += sh[q];
      hf[bin[q] * 3 + 2] += sc[q];
    }
    __syncwarp();  // this group's adds land before the next group's
  }
}

// Rows [begin + r0, begin + r1) of the matrix into hist_s (features
// f0 .. f0 + nf, nf <= kTileFeatures, f0 a multiple of 4). The
// caller zeroes hist_s; on return the block is synchronised and hist_s
// complete. stage: the shared bytes past hist_s (hist_smem_bytes).
// kTimed: thread 0 adds its cycles waiting for and storing the staged
// rows to clk[0] and accumulating them to clk[1].
template <bool kL2, bool kTimed = false>
__device__ __forceinline__ void hist_rows(const uint8_t* mat,
                                          long long begin, int stride,
                                          int pay_off, long long r0,
                                          long long r1, int f0, int nf,
                                          int num_bins, double* hist_s,
                                          unsigned char* stage,
                                          unsigned long long* clk = nullptr) {
  float* g_s = reinterpret_cast<float*>(stage);  // [kStepRows] each
  float* h_s = g_s + kStepRows;
  float* c_s = h_s + kStepRows;
  uint8_t* bin_s = reinterpret_cast<uint8_t*>(c_s + kStepRows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  StagedRow st;
  if (r0 < r1 && (long long)threadIdx.x < r1 - r0)
    load_row<kL2>(mat + (size_t)(begin + r0) * stride, stride, pay_off, f0,
                  nf, st);
  unsigned long long t_clk = kTimed ? clock64() : 0;
  for (long long t0 = r0; t0 < r1; t0 += kStepRows) {
    const int m = (int)min((long long)kStepRows, r1 - t0);
    __syncthreads();  // the last step's stage is read
    if ((int)threadIdx.x < m) {
      g_s[threadIdx.x] = st.g;
      h_s[threadIdx.x] = st.h;
      c_s[threadIdx.x] = st.c;
#pragma unroll
      for (int fl = 0; fl < kTileFeatures; ++fl)
        if (fl < nf)
          bin_s[fl * kStepRows + threadIdx.x] =
              (uint8_t)(st.w[fl >> 2] >> (8 * (fl & 3)));
    }
    __syncthreads();
    if constexpr (kTimed) {
      if (threadIdx.x == 0) {
        const unsigned long long now = clock64();
        clk[0] += now - t_clk;
        t_clk = now;
      }
    }
    const long long t1 = t0 + kStepRows;
    if (t1 < r1 && (long long)threadIdx.x < r1 - t1)
      load_row<kL2>(mat + (size_t)(begin + t1) * stride, stride, pay_off,
                    f0, nf, st);
    if (warp < nf) {
      double* hf = hist_s + (size_t)warp * num_bins * 3;
      const uint8_t* bs = bin_s + warp * kStepRows;
      for (int base = 0; base < m; base += 32 * kGroups)
        add_groups(bs, base, m, lane, g_s, h_s, c_s, hf);
    }
    if constexpr (kTimed) {
      if (threadIdx.x == 0) {
        const unsigned long long now = clock64();
        clk[1] += now - t_clk;
        t_clk = now;
      }
    }
  }
  __syncthreads();
}

}  // namespace ltt
