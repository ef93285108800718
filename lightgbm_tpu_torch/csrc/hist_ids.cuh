// Device code of the row-list histogram, shared by the leaf-layout fused
// split step (split_step_leaf.cu: the smaller child's histogram) and the
// full-range histogram (hist_rows.cu: the serial learner's root and
// per-phase histograms), so both sum every bin in the same order and a
// child's histogram from one equals the other's bit for bit.
//
// Rows come from a list in row order: row ids[i] (the fused step's
// compacted child, or a per-phase child's ids), or row i itself (all
// rows: no list is read). Bins are [N, F] row-major, u8, u16 or (past
// 32,768 bins) u32; ghc [N, 3] f32 (grad, hess, count), the count a 0/1
// indicator. A block may take one window of a feature's bins
// [bin_lo, bin_lo + B) (hist_rows.cu past the bins whose tile fits
// shared memory): it reads its chunk's rows as any block does and adds
// only the rows whose bin is inside its window, so a window adds no
// step to a bin's sum.
//
// The chunk rule: a list of sc rows is cut into child_chunks(sc,
// max_chunks_of(F, feat_tile)) contiguous chunks of ceil(sc / chunks)
// rows (kChunkRows rows a chunk, at most kMaxVBlocks / feature tiles
// chunks), from the row count, F and the feature tile alone: never the
// grid, never the card. A block sums one (chunk, feature tile) virtual
// block with hist_chunk: kStageRows rows staged through registers into
// shared memory (the next step's loads in flight while this step is
// accumulated), warp w owning features w, w + kWarps, ... of the tile.
// Each 32-row group of a feature adds, into each bin it hits, the sum
// of its lanes of that bin in lane order (float64, from 0), one add a
// bin, groups in order. So every bin's sum is fixed by the row order
// within the chunk. The chunks' float64 partials are then summed in
// chunk order and rounded once to float32, as the plain version
// (ops/histogram.py build_histogram) accumulates in float64 and rounds
// once. The Python mirror of the constants is ops/hist_cuda.py (LEAF_*).
//
// How a group finds the lanes of one bin (add_groups): not with
// __match_any_sync, whose cost (~40 SM cycles a warp-wide call with ~30
// distinct bins on the H100, chip_hist_levers.py) was most of the
// accumulation.
// Each tile bin holds (g, h) as one double2 and a uint2 (peers, count).
// Every lane of a group ORs its lane bit into its bin's peer word
// (integer atomics: the word is the same whatever their order), then
// reads the word back: the lowest lane of the word leads, adds its
// peers' g and h in lane order into the double2, adds the popcount of
// its peers' count bits (one ballot a group at staging) to the count
// and clears the peer word for the next group. The count is exact as an
// integer: it equals the float64 sum of a 0/1 column.
#pragma once

#include "common.cuh"

namespace ltt {
namespace ids {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 512;    // rows staged per step
constexpr int kPer = kStageRows / kThreads;  // staged rows per thread
constexpr int kStageGroups = kStageRows / 32;  // count-bit words a step
constexpr int kMaxTile = 16;       // features per histogram tile, at most
constexpr int kChunkRows = 512;    // rows per histogram chunk
constexpr int kMaxVBlocks = 256;   // cap of chunks x feature tiles
constexpr int kGroups = 4;         // 32-row groups a warp has loaded
constexpr int kBinBytes = 24;      // a tile bin: double2 (g, h), uint2
constexpr int kStageRowBytes = 8;  // a staged row's float2 (g, h)
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

// Shared bytes of one histogram block: the tile's bins ([feat_tile][B]
// double2, then uint2) and the staged rows' (g, h) pairs, count bits and
// tile bins ([feat_tile][kStageRows]).
__host__ __device__ inline size_t tile_smem_bytes(int bin_bytes, int B,
                                                  int feat_tile) {
  return (size_t)feat_tile * B * kBinBytes +
         (size_t)kStageRows * kStageRowBytes + kStageGroups * 4 +
         (size_t)feat_tile * kStageRows * bin_bytes;
}

// The same bytes, carved from a block's dynamic shared memory.
template <typename BinT>
struct TileSmem {
  double2* gh;      // [feat_tile][B] (sum g, sum h)
  uint2* pc;        // [feat_tile][B] (peer word, count)
  float2* sgh;      // [kStageRows] staged (g, h)
  unsigned* cbits;  // [kStageGroups] staged count bits, a word a group
  BinT* bin;        // [feat_tile][kStageRows] staged tile bins
};

template <typename BinT>
__device__ __forceinline__ TileSmem<BinT> carve(unsigned char* dyn,
                                                int feat_tile, int B) {
  TileSmem<BinT> s;
  s.gh = reinterpret_cast<double2*>(dyn);
  s.pc = reinterpret_cast<uint2*>(s.gh + (size_t)feat_tile * B);
  s.sgh = reinterpret_cast<float2*>(s.pc + (size_t)feat_tile * B);
  s.cbits = reinterpret_cast<unsigned*>(s.sgh + kStageRows);
  s.bin = reinterpret_cast<BinT*>(s.cbits + kStageGroups);
  return s;
}

// Element i of the finished tile as [nf][B][3] float64 (sum g, sum h,
// count): one load, from the pair or from the count hist_chunk wrote
// over the bin's (peer word, count) as a double.
template <typename BinT>
__device__ __forceinline__ double tile_value(const TileSmem<BinT>& s,
                                             int i) {
  const int k = i / 3, ch = i - 3 * k;
  const double* p = ch < 2 ? reinterpret_cast<const double*>(s.gh) + 2 * k + ch
                           : reinterpret_cast<const double*>(s.pc) + k;
  return *p;
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

// One warp adds kGroups consecutive 32-row groups of the stage into one
// feature's tile bins (bs: the feature's staged bins; rows from base, m
// rows staged). Group by group: the lanes OR their bits into their
// bins' peer words, read them back, and the lowest lane of each word
// adds its peers in lane order, adds the popcount of their count bits
// and clears the word. A bin's sum therefore depends on the row order
// alone, as with __match_any_sync. kOwn: each lane's own (g, h) and its
// group's count bits come from registers (own, cb: loaded once for the
// warp's features), else the leader reads them from the stage; the same
// sums.
template <typename BinT, bool kOwn>
__device__ __forceinline__ void add_groups(const BinT* bs, int base, int m,
                                           int lane, const float2* sgh,
                                           const unsigned* cbits,
                                           const float2 (&own)[kGroups],
                                           const unsigned (&cb)[kGroups],
                                           double2* gh, uint2* pc,
                                           int bin_lo, int nbw) {
  int bin[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int j = base + 32 * q + lane;
    const int b = j < m ? (int)bs[j] - bin_lo : -1;
    bin[q] = b < nbw ? b : -1;
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int b = bin[q];
    if (b >= 0) atomicOr(&pc[b].x, 1u << lane);
    __syncwarp();
    uint2 w = make_uint2(0u, 0u);
    if (b >= 0) w = pc[b];
    __syncwarp();  // every lane's read lands before its leader clears
    if (b >= 0 && (w.x & ((1u << lane) - 1u)) == 0u) {
      double g = 0.0, h = 0.0;
      unsigned mm = w.x;
      if constexpr (kOwn) {
        g += (double)own[q].x;
        h += (double)own[q].y;
        mm &= mm - 1u;
      }
      for (; mm; mm &= mm - 1u) {
        const float2 v = sgh[base + 32 * q + __ffs(mm) - 1];
        g += (double)v.x;
        h += (double)v.y;
      }
      double2 d = gh[b];
      d.x += g;
      d.y += h;
      gh[b] = d;
      const unsigned bits = kOwn ? cb[q] : cbits[(base >> 5) + q];
      pc[b] = make_uint2(0u, w.y + __popc(w.x & bits));
    }
    __syncwarp();  // this group's adds land before the next group's
  }
}

// Whole block: list positions [i0, i1) into the tile of features f0 ..
// f0 + nf (zeroed here), bins [bin_lo, bin_lo + B) of each. A two-step pipeline: the rows of step s + 1
// load into registers while step s is accumulated, the ids of step s + 2
// likewise. On return the tile is complete, each count a double in its
// bin's (peer word, count) slot (every peer word is 0 by then), and
// visible to the whole block (tile_value). Laps: 0 first fetch, 1
// stores, 2 accumulation.
template <typename BinT, bool kIds, bool kTimed, bool kOwn>
__device__ __forceinline__ void hist_chunk(const int* ids, long long i0,
                                           long long i1, const float* ghc,
                                           const BinT* bins, int F, int f0,
                                           int nf, int B,
                                           const TileSmem<BinT>& sm,
                                           Laps<kTimed>& clk,
                                           int bin_lo = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nf * B; i += kThreads) {
    sm.gh[i] = make_double2(0.0, 0.0);
    sm.pc[i] = make_uint2(0u, 0u);
  }
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
      // staged row j = u * kThreads + threadIdx.x: a warp's 32 rows are
      // group u * kWarps + warp, one ballot its count bits
      const int j = u * kThreads + threadIdx.x;
      const bool ok = st.rid[u] >= 0;
      const unsigned bits = __ballot_sync(kFull, ok && st.c[u] != 0.0f);
      if (lane == 0) sm.cbits[u * kWarps + warp] = bits;
      if (!ok) continue;
      sm.sgh[j] = make_float2(st.g[u], st.h[u]);
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
    if (warp >= nf) continue;
    for (int base = 0; base < m; base += 32 * kGroups) {
      float2 own[kGroups];
      unsigned cb[kGroups];
      if constexpr (kOwn) {
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          const int j = base + 32 * q + lane;
          own[q] = j < m ? sm.sgh[j] : make_float2(0.0f, 0.0f);
          cb[q] = sm.cbits[(base >> 5) + q];
        }
      }
      for (int fl = warp; fl < nf; fl += kWarps)
        add_groups<BinT, kOwn>(sm.bin + fl * kStageRows, base, m, lane,
                               sm.sgh, sm.cbits, own, cb,
                               sm.gh + (size_t)fl * B,
                               sm.pc + (size_t)fl * B, bin_lo, B);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nf * B; i += kThreads)
    reinterpret_cast<double*>(sm.pc)[i] = (double)sm.pc[i].y;
  __syncthreads();
  clk.lap(2);
}

}  // namespace ids
}  // namespace ltt
