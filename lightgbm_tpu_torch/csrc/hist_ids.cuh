// Device code of the row-list histogram, shared by the leaf-layout fused
// split step (split_step_leaf.cu: the smaller child's histogram) and the
// full-range histogram (hist_rows.cu: the serial learner's root and
// per-phase histograms), so both sum every bin in the same order and a
// child's histogram from one equals the other's bit for bit.
//
// Rows come from a list in row order: row ids[i] (the fused step's
// compacted child, or a per-phase child's ids), or row i itself (all
// rows: no list is read). Bins are [N, F] row-major, u8 or u16; ghc
// [N, 3] f32 (grad, hess, count).
//
// The chunk rule: a list of sc rows is cut into child_chunks(sc,
// max_chunks_of(F, feat_tile)) contiguous chunks of ceil(sc / chunks)
// rows (kChunkRows rows a chunk, at most kMaxVBlocks / feature tiles
// chunks), from the row count, F and the feature tile alone: never the
// grid, never the card. A block sums one (chunk, feature tile) virtual
// block with hist_chunk: kStageRows rows staged through registers into
// shared memory (the next step's loads in flight while this step is
// accumulated), warp w owning features w, w + kWarps, ... of the tile;
// for each feature and 32-row group __match_any_sync finds the lanes of
// one bin and the lowest adds its peers in lane order (float64), kGroups
// groups in flight, their adds landing group by group. So every bin's
// sum is fixed by the row order within the chunk. The chunks' float64
// partials are then summed in chunk order and rounded once to float32,
// as the plain version (ops/histogram.py build_histogram) accumulates in
// float64 and rounds once. The Python mirror of the constants is
// ops/hist_cuda.py (LEAF_*).
#pragma once

#include "common.cuh"

namespace ltt {
namespace ids {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 512;    // rows staged per step
constexpr int kPer = kStageRows / kThreads;  // staged rows per thread
constexpr int kMaxTile = 16;       // features per histogram tile, at most
constexpr int kChunkRows = 512;    // rows per histogram chunk
constexpr int kMaxVBlocks = 256;   // cap of chunks x feature tiles
constexpr int kGroups = 4;         // 32-row groups a warp has in flight
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int feature_tiles(int F, int feat_tile) {
  return (F + feat_tile - 1) / feat_tile;
}

// The most chunks of a list (the leading dimension of the partials).
__host__ __device__ inline int max_chunks_of(int F, int feat_tile) {
  const int nft = feature_tiles(F, feat_tile);
  return kMaxVBlocks / nft > 1 ? kMaxVBlocks / nft : 1;
}

// The chunks of a list of sc rows: from sc and the feature tiles only.
__host__ __device__ inline int child_chunks(long long sc, int max_chunks) {
  const long long c = (sc + kChunkRows - 1) / kChunkRows;
  return (int)(c < 1 ? 1 : (c > max_chunks ? max_chunks : c));
}

// Shared bytes of one histogram block: the float64 tile [feat_tile][B][3]
// and the staged rows' ghc (f32) and tile bins ([feat_tile][kStageRows]).
__host__ __device__ inline size_t tile_smem_bytes(int bin_bytes, int B,
                                                  int feat_tile) {
  return (size_t)feat_tile * B * 3 * sizeof(double) +
         (size_t)kStageRows * 3 * sizeof(float) +
         (size_t)feat_tile * kStageRows * bin_bytes;
}

// The same bytes, carved from a block's dynamic shared memory.
template <typename BinT>
struct TileSmem {
  double* hist;
  float *g, *h, *c;
  BinT* bin;
};

template <typename BinT>
__device__ __forceinline__ TileSmem<BinT> carve(unsigned char* dyn,
                                                int feat_tile, int B) {
  TileSmem<BinT> s;
  s.hist = reinterpret_cast<double*>(dyn);
  s.g = reinterpret_cast<float*>(s.hist + (size_t)feat_tile * B * 3);
  s.h = s.g + kStageRows;
  s.c = s.h + kStageRows;
  s.bin = reinterpret_cast<BinT*>(s.c + kStageRows);
  return s;
}

// cycles since the last lap into acc (a timed caller, thread 0's view)
template <bool kTimed>
struct Laps {
  unsigned long long t = 0, acc[4] = {0, 0, 0, 0};
  __device__ __forceinline__ void start() {
    if constexpr (kTimed) t = clock64();
  }
  __device__ __forceinline__ void lap(int i) {
    if constexpr (kTimed) {
      const unsigned long long now = clock64();
      acc[i] += now - t;
      t = now;
    }
  }
};

// One thread's share of a staged step: kPer rows' ids, ghc and the
// tile's bins, in registers while the previous step is accumulated.
template <typename BinT>
struct Staged {
  int rid[kPer];
  float g[kPer], h[kPer], c[kPer];
  BinT bin[kPer][kMaxTile];
};

// the row ids of list positions [s0, s0 + m): ids[i] (kIds), else i
template <bool kIds>
__device__ __forceinline__ void load_ids(const int* ids, long long s0, int m,
                                         int (&rid)[kPer]) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = u * kThreads + threadIdx.x;
    if constexpr (kIds)
      rid[u] = j < m ? __ldcg(ids + s0 + j) : -1;
    else
      rid[u] = j < m ? (int)(s0 + j) : -1;
  }
}

// the rows' ghc and tile bins, every load issued before any is used
template <typename BinT>
__device__ __forceinline__ void load_rows(const float* ghc, const BinT* bins,
                                          int F, int f0, int nf,
                                          Staged<BinT>& st) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (st.rid[u] < 0) continue;
    const float* gp = ghc + (size_t)st.rid[u] * 3;
    st.g[u] = gp[0];
    st.h[u] = gp[1];
    st.c[u] = gp[2];
    const BinT* rp = bins + (size_t)st.rid[u] * F + f0;
#pragma unroll
    for (int fl = 0; fl < kMaxTile; ++fl)
      if (fl < nf) st.bin[u][fl] = rp[fl];
  }
}

// One warp adds kGroups consecutive 32-row groups of the stage into the
// float64 bins of one feature (bs: the feature's staged bins; rows from
// base, m rows staged). In each group the lanes of one bin are found
// with __match_any_sync and the lowest adds its peers in lane order;
// the matches and sums of all groups are in flight together, their adds
// into hf land group by group. A bin's sum therefore depends on the
// row order alone.
template <typename BinT>
__device__ __forceinline__ void add_groups(const BinT* bs, int base, int m,
                                           int lane, const float* g_s,
                                           const float* h_s,
                                           const float* c_s, double* hf) {
  int bin[kGroups];
  unsigned peers[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int j = base + 32 * q + lane;
    bin[q] = j < m ? (int)bs[j] : -1;
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) peers[q] = __match_any_sync(kFull, bin[q]);
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

// Whole block: list positions [i0, i1) into sm.hist, the float64 tile
// of features f0 .. f0 + nf (zeroed here). A two-step pipeline: the rows
// of step s + 1 load into registers while step s is accumulated, the ids
// of step s + 2 likewise. On return sm.hist is complete and visible to
// the whole block. Laps: 0 first fetch, 1 stores, 2 accumulation.
template <typename BinT, bool kIds, bool kTimed>
__device__ __forceinline__ void hist_chunk(const int* ids, long long i0,
                                           long long i1, const float* ghc,
                                           const BinT* bins, int F, int f0,
                                           int nf, int B,
                                           const TileSmem<BinT>& sm,
                                           Laps<kTimed>& clk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n3 = nf * B * 3;
  for (int i = threadIdx.x; i < n3; i += kThreads) sm.hist[i] = 0.0;
  Staged<BinT> st;
  int nid[kPer];
  load_ids<kIds>(ids, i0, (int)min((long long)kStageRows, i1 - i0), st.rid);
  load_rows(ghc, bins, F, f0, nf, st);
  load_ids<kIds>(ids, i0 + kStageRows,
                 (int)max(0LL, min((long long)kStageRows,
                                   i1 - i0 - kStageRows)),
                 nid);
  clk.lap(0);
  for (long long s0 = i0; s0 < i1; s0 += kStageRows) {
    const int m = (int)min((long long)kStageRows, i1 - s0);
    __syncthreads();  // the last step's stage is read (and the tile zeroed)
    clk.lap(2);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = u * kThreads + threadIdx.x;
      if (st.rid[u] < 0) continue;
      sm.g[j] = st.g[u];
      sm.h[j] = st.h[u];
      sm.c[j] = st.c[u];
#pragma unroll
      for (int fl = 0; fl < kMaxTile; ++fl)
        if (fl < nf) sm.bin[fl * kStageRows + j] = st.bin[u][fl];
    }
    __syncthreads();
    clk.lap(1);
    const long long s1 = s0 + kStageRows;
    if (s1 < i1) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) st.rid[u] = nid[u];
      load_rows(ghc, bins, F, f0, nf, st);
      load_ids<kIds>(ids, s1 + kStageRows,
                     (int)max(0LL, min((long long)kStageRows,
                                       i1 - s1 - kStageRows)),
                     nid);
    }
    for (int fl = warp; fl < nf; fl += kWarps) {
      double* hf = sm.hist + (size_t)fl * B * 3;
      const BinT* bs = sm.bin + fl * kStageRows;
      for (int base = 0; base < m; base += 32 * kGroups)
        add_groups(bs, base, m, lane, sm.g, sm.h, sm.c, hf);
    }
  }
  __syncthreads();
  clk.lap(2);
}

}  // namespace ids
}  // namespace ltt
