// Levers of the row-list histogram's accumulation (the loop of
// lightgbm_tpu_torch/csrc/hist_ids.cuh), each a kernel of its own, for
// chip_hist_levers.py, which builds this file with nvcc, runs every lever
// on one card at 2M x 28 and holds each against the shipped kernel
// (hist_rows.cu) bit for bit. Not part of the package.
//
// Lever 0 ("before") is the loop the shipped one replaced: three float64
// a bin, __match_any_sync to find a 32-row group's lanes of one bin.
// Levers 1-7 keep the match and restructure the rest: the count as an
// integer plane, g and h as one double2, the lane's own (g, h) from
// registers, the count by shared atomics, the bins of a feature split
// across the idle warps; 6 and 7 are diagnostics with wrong sums (no
// match: every lane its own leader; no shared-memory adds). Lever 8
// finds collisions through per-warp byte tags and matches only the lanes
// that collide. Levers 9-13 find the lanes through a (peer word, count)
// pair a bin, the shipped design (9), with 2 or 8 groups loaded (10,
// 11), split bins (12), or the lane whose atomicOr found the word empty
// leading (13). Every non-diagnostic lever adds each bin's lanes in lane
// order, group by group, so its sums equal the shipped kernel's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace before {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 512;    // rows staged per step
constexpr int kPer = kStageRows / kThreads;  // staged rows per thread
constexpr int kMaxTile = 16;       // features per histogram tile, at most
constexpr int kChunkRows = 512;    // rows per histogram chunk
constexpr int kMaxVBlocks = 256;   // cap of chunks x feature tiles
constexpr int kGroups = 4;         // 32-row groups a warp has in flight
constexpr unsigned kFull = 0xffffffffu;


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
template <typename BinT, bool kIds>
__device__ __forceinline__ void hist_chunk(const int* ids, long long i0,
                                           long long i1, const float* ghc,
                                           const BinT* bins, int F, int f0,
                                           int nf, int B,
                                           const TileSmem<BinT>& sm) {
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
  for (long long s0 = i0; s0 < i1; s0 += kStageRows) {
    const int m = (int)min((long long)kStageRows, i1 - s0);
    __syncthreads();  // the last step's stage is read (and the tile zeroed)
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
}


template <typename BinT, bool kIds>
__global__ void __launch_bounds__(kThreads)
kern(const BinT* bins, const float* ghc, const int* ids, long long count,
     int F, int B, int tile, int chunks, double* partial, float* out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nft = (F + tile - 1) / tile;
  const int c = blockIdx.x / nft, f0 = (blockIdx.x % nft) * tile;
  const int nf = min(tile, F - f0);
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const TileSmem<BinT> sm = carve<BinT>(dyn, tile, B);
  hist_chunk<BinT, kIds>(ids, i0, i1, ghc, bins, F, f0, nf, B, sm);
  const size_t off = (size_t)f0 * B * 3;
  double* dst = partial + (size_t)c * F * B * 3 + off;
  for (int i = threadIdx.x; i < nf * B * 3; i += kThreads) {
    if (chunks == 1)
      out[off + i] = (float)sm.hist[i];
    else
      dst[i] = sm.hist[i];
  }
}
}  // namespace before

// ---- levers 1-13: (g, h) pairs and a count plane, staged (g, h) pairs
// and count bits ------------------------------------------------------
namespace x {
constexpr int kThreads = 256, kWarps = 8, kStageRows = 512;
constexpr int kPer = kStageRows / kThreads, kMaxTile = 16;
constexpr int kStageGroups = kStageRows / 32;
constexpr unsigned kFull = 0xffffffffu;


__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline size_t smem_bytes(int bb, int B, int tile) {
  return (size_t)tile * B * 16 + (size_t)round4(tile * B) * 4 +
         (size_t)kStageRows * 8 + kStageGroups * 4 +
         (size_t)tile * kStageRows * bb;
}

template <typename BinT>
struct Smem {
  double2* gh;
  int* cnt;
  float2* sgh;
  unsigned* cbits;
  BinT* bin;
};

template <typename BinT>
__device__ Smem<BinT> carve(unsigned char* dyn, int tile, int B) {
  Smem<BinT> s;
  s.gh = reinterpret_cast<double2*>(dyn);
  s.cnt = reinterpret_cast<int*>(s.gh + (size_t)tile * B);
  s.sgh = reinterpret_cast<float2*>(s.cnt + round4(tile * B));
  s.cbits = reinterpret_cast<unsigned*>(s.sgh + kStageRows);
  s.bin = reinterpret_cast<BinT*>(s.cbits + kStageGroups);
  return s;
}

template <typename BinT>
struct Staged {
  int rid[kPer];
  float g[kPer], h[kPer], c[kPer];
  BinT bin[kPer][kMaxTile];
};

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

// levers 1-7: one warp, one feature, G groups from base
template <typename BinT, int G, bool kPair, bool kOwn, bool kNoMatch,
          bool kNoRmw, bool kAtomicCnt>
__device__ __forceinline__ void add_groups(
    const BinT* bs, int base, int m, int lane, const float2* sgh,
    const float2 (&own)[G], const unsigned (&cb)[G], double2* gh,
    double* hg, double* hh, int* cnt, int lo, int hi, double2& sink) {
  int bin[G];
  unsigned peers[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int j = base + 32 * q + lane;
    bin[q] = j < m ? (int)bs[j] : -1;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if constexpr (kNoMatch)
      peers[q] = 1u << lane;
    else
      peers[q] = __match_any_sync(kFull, bin[q]);
  }
  double sg[G], sh[G];
  bool lead[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    lead[q] = bin[q] >= lo && bin[q] < hi &&
              (peers[q] & ((1u << lane) - 1u)) == 0u;
    double g = 0.0, h = 0.0;
    if (lead[q]) {
      unsigned mm = peers[q];
      if constexpr (kOwn) {
        g += (double)own[q].x;
        h += (double)own[q].y;
        mm &= mm - 1;
      }
      while (mm) {
        const int p = base + 32 * q + __ffs(mm) - 1;
        mm &= mm - 1;
        const float2 v = sgh[p];
        g += (double)v.x;
        h += (double)v.y;
      }
    }
    sg[q] = g;
    sh[q] = h;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (lead[q]) {
      const int n1 = __popc(peers[q] & cb[q]);
      if constexpr (kNoRmw) {
        sink.x += sg[q];
        sink.y += sh[q] + n1;
      } else {
        if constexpr (kPair) {
          double2 v = gh[bin[q]];
          v.x += sg[q];
          v.y += sh[q];
          gh[bin[q]] = v;
        } else {
          hg[bin[q]] += sg[q];
          hh[bin[q]] += sh[q];
        }
        if constexpr (kAtomicCnt)
          atomicAdd(cnt + bin[q], n1);
        else
          cnt[bin[q]] += n1;
      }
    }
    if constexpr (!kNoRmw) __syncwarp();
  }
}


// ---- tags: each lane writes its lane id into a per-warp byte tag of its
// bin and reads it back; only lanes that lost or were named by a loser
// take a __match_any_sync, over just those lanes
template <typename BinT, int G, bool kAtomicCnt>
__device__ __forceinline__ void add_groups_tag(
    const BinT* bs, int base, int m, int lane, const float2* sgh,
    const float2 (&own)[G], const unsigned (&cb)[G], double2* gh, int* cnt,
    unsigned char* tags, int Bp) {
  int bin[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int j = base + 32 * q + lane;
    bin[q] = j < m ? (int)bs[j] : -1;
  }
#pragma unroll
  for (int q = 0; q < G; ++q)
    if (bin[q] >= 0) tags[q * Bp + bin[q]] = (unsigned char)lane;
  __syncwarp();
  unsigned peers[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int t = bin[q] >= 0 ? (int)tags[q * Bp + bin[q]] : lane;
    const bool loser = t != lane;
    const unsigned lost = __ballot_sync(kFull, loser);
    peers[q] = 1u << lane;
    if (lost) {
      const unsigned won = __reduce_or_sync(kFull, loser ? 1u << t : 0u);
      const unsigned coll = lost | won;
      if ((coll >> lane) & 1u) peers[q] = __match_any_sync(coll, bin[q]);
    }
  }
  double sg[G], sh[G];
  bool lead[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    lead[q] = bin[q] >= 0 && (peers[q] & ((1u << lane) - 1u)) == 0u;
    double g = 0.0, h = 0.0;
    if (lead[q]) {
      g += (double)own[q].x;
      h += (double)own[q].y;
      unsigned mm = peers[q] & (peers[q] - 1u);
      while (mm) {
        const int p = base + 32 * q + __ffs(mm) - 1;
        mm &= mm - 1;
        const float2 v = sgh[p];
        g += (double)v.x;
        h += (double)v.y;
      }
    }
    sg[q] = g;
    sh[q] = h;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (lead[q]) {
      const int n1 = __popc(peers[q] & cb[q]);
      double2 v = gh[bin[q]];
      v.x += sg[q];
      v.y += sh[q];
      gh[bin[q]] = v;
      if constexpr (kAtomicCnt)
        atomicAdd(cnt + bin[q], n1);
      else
        cnt[bin[q]] += n1;
    }
    __syncwarp();
  }
}

__host__ __device__ inline int tag_bp(int B) { return (B + 15) & ~15; }

__host__ __device__ inline size_t tag_bytes(int B, int tile, int G) {
  return (size_t)(tile < kWarps ? tile : kWarps) * G * tag_bp(B);
}

template <typename BinT, bool kIds, int G, bool kAtomicCnt>
__device__ void hist_chunk_tag(const int* ids, long long i0, long long i1,
                               const float* ghc, const BinT* bins, int F,
                               int f0, int nf, int B, int tile,
                               const Smem<BinT>& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nf * B; i += kThreads) {
    sm.gh[i] = make_double2(0.0, 0.0);
    sm.cnt[i] = 0;
  }
  const int Bp = tag_bp(B);
  unsigned char* tag_base = reinterpret_cast<unsigned char*>(
      sm.bin + (size_t)tile * kStageRows);
  tag_base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(tag_base) + 15) & ~(size_t)15);
  unsigned char* tags = tag_base + (size_t)warp * G * Bp;
  Staged<BinT> st;
  int nid[kPer];
  load_ids<kIds>(ids, i0, (int)min((long long)kStageRows, i1 - i0), st.rid);
  load_rows(ghc, bins, F, f0, nf, st);
  load_ids<kIds>(ids, i0 + kStageRows,
                 (int)max(0LL, min((long long)kStageRows,
                                   i1 - i0 - kStageRows)),
                 nid);
  for (long long s0 = i0; s0 < i1; s0 += kStageRows) {
    const int m = (int)min((long long)kStageRows, i1 - s0);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
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
    if (warp < nf) {
      for (int base = 0; base < m; base += 32 * G) {
        float2 own[G];
        unsigned cb[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int j = base + 32 * q + lane;
          own[q] = j < m ? sm.sgh[j] : make_float2(0.f, 0.f);
          cb[q] = sm.cbits[((base >> 5) + q) & (kStageGroups - 1)];
        }
        for (int fl = warp; fl < nf; fl += kWarps)
          add_groups_tag<BinT, G, kAtomicCnt>(
              sm.bin + fl * kStageRows, base, m, lane, sm.sgh, own, cb,
              sm.gh + (size_t)fl * B, sm.cnt + (size_t)fl * B, tags, Bp);
      }
    }
  }
  __syncthreads();
}

template <typename BinT, bool kIds, int G, bool kAtomicCnt>
__global__ void __launch_bounds__(kThreads)
kern_tag(const BinT* bins, const float* ghc, const int* ids, long long count,
         int F, int B, int tile, int chunks, double* partial, float* out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nft = (F + tile - 1) / tile;
  const int c = blockIdx.x / nft, f0 = (blockIdx.x % nft) * tile;
  const int nf = min(tile, F - f0);
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const Smem<BinT> sm = carve<BinT>(dyn, tile, B);
  hist_chunk_tag<BinT, kIds, G, kAtomicCnt>(ids, i0, i1, ghc, bins, F,
                                                   f0, nf, B, tile, sm);
  const size_t off = (size_t)f0 * B * 3;
  double* dst = partial + (size_t)c * F * B * 3 + off;
  for (int i = threadIdx.x; i < nf * B * 3; i += kThreads) {
    const int k = i / 3, ch = i - 3 * k;
    const double v =
        ch == 0 ? sm.gh[k].x : ch == 1 ? sm.gh[k].y : (double)sm.cnt[k];
    if (chunks == 1)
      out[off + i] = (float)v;
    else
      dst[i] = v;
  }
}


// ---- peer words: the count plane is (peer mask, count) a bin ---------
__host__ __device__ inline size_t mask_smem_bytes(int bb, int B, int tile) {
  return (size_t)tile * B * 24 + (size_t)kStageRows * 8 + kStageGroups * 4 +
         (size_t)tile * kStageRows * bb;
}

template <typename BinT>
struct MSmem {
  double2* gh;
  uint2* mc;
  float2* sgh;
  unsigned* cbits;
  BinT* bin;
};

template <typename BinT>
__device__ MSmem<BinT> mcarve(unsigned char* dyn, int tile, int B) {
  MSmem<BinT> s;
  s.gh = reinterpret_cast<double2*>(dyn);
  s.mc = reinterpret_cast<uint2*>(s.gh + (size_t)tile * B);
  s.sgh = reinterpret_cast<float2*>(s.mc + (size_t)tile * B);
  s.cbits = reinterpret_cast<unsigned*>(s.sgh + kStageRows);
  s.bin = reinterpret_cast<BinT*>(s.cbits + kStageGroups);
  return s;
}

// one warp, one feature, G groups from base, bins [lo, hi) only
template <typename BinT, int G>
__device__ __forceinline__ void add_groups_mask(
    const BinT* bs, int base, int m, int lane, const float2* sgh,
    const float2 (&own)[G], const unsigned (&cb)[G], double2* gh, uint2* mc,
    int lo, int hi) {
  int bin[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int j = base + 32 * q + lane;
    const int b = j < m ? (int)bs[j] : -1;
    bin[q] = b >= lo && b < hi ? b : -1;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int b = bin[q];
    if (b >= 0) atomicOr(&mc[b].x, 1u << lane);
    __syncwarp();
    uint2 w = make_uint2(0u, 0u);
    if (b >= 0) w = mc[b];
    __syncwarp();  // every lane's read lands before its leader clears
    {
      const unsigned peers = w.x;
      if (b >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
        double g = 0.0, h = 0.0;
        g += (double)own[q].x;
        h += (double)own[q].y;
        unsigned mm = peers & (peers - 1u);
        while (mm) {
          const int p = base + 32 * q + __ffs(mm) - 1;
          mm &= mm - 1;
          const float2 v = sgh[p];
          g += (double)v.x;
          h += (double)v.y;
        }
        double2 d = gh[b];
        d.x += g;
        d.y += h;
        gh[b] = d;
        mc[b] = make_uint2(0u, w.y + __popc(peers & cb[q]));
      }
    }
    __syncwarp();
  }
}

// designated lane: the lane whose atomicOr found the mask empty walks
// the peers (all of them, in lane order) and clears the mask
template <typename BinT, int G>
__device__ __forceinline__ void add_groups_first(
    const BinT* bs, int base, int m, int lane, const float2* sgh,
    const float2 (&own)[G], const unsigned (&cb)[G], double2* gh, uint2* mc,
    int lo, int hi) {
  int bin[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int j = base + 32 * q + lane;
    const int b = j < m ? (int)bs[j] : -1;
    bin[q] = b >= lo && b < hi ? b : -1;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int b = bin[q];
    const bool first = b >= 0 && atomicOr(&mc[b].x, 1u << lane) == 0u;
    __syncwarp();
    if (first) {
      const uint2 w = mc[b];
      const unsigned peers = w.x;
      double g = 0.0, h = 0.0;
      if (peers == 1u << lane) {
        g += (double)own[q].x;
        h += (double)own[q].y;
      } else {
        unsigned mm = peers;
        while (mm) {
          const int p = base + 32 * q + __ffs(mm) - 1;
          mm &= mm - 1;
          const float2 v = sgh[p];
          g += (double)v.x;
          h += (double)v.y;
        }
      }
      double2 d = gh[b];
      d.x += g;
      d.y += h;
      gh[b] = d;
      mc[b] = make_uint2(0u, w.y + __popc(peers & cb[q]));
    }
    __syncwarp();
  }
}

template <typename BinT, bool kIds, int G, bool kSplit, bool kFirst>
__device__ void hist_chunk_mask(const int* ids, long long i0, long long i1,
                                const float* ghc, const BinT* bins, int F,
                                int f0, int nf, int B, const MSmem<BinT>& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nf * B; i += kThreads) {
    sm.gh[i] = make_double2(0.0, 0.0);
    sm.mc[i] = make_uint2(0u, 0u);
  }
  int fl0 = warp, fstep = kWarps, lo = 0, hi = B;
  if (kSplit && nf < kWarps) {
    const int wpf = kWarps / nf;
    fl0 = warp / wpf < nf ? warp / wpf : nf;
    fstep = kWarps;
    const int part = warp % wpf, width = (B + wpf - 1) / wpf;
    lo = part * width;
    hi = min(B, lo + width);
  }
  Staged<BinT> st;
  int nid[kPer];
  load_ids<kIds>(ids, i0, (int)min((long long)kStageRows, i1 - i0), st.rid);
  load_rows(ghc, bins, F, f0, nf, st);
  load_ids<kIds>(ids, i0 + kStageRows,
                 (int)max(0LL, min((long long)kStageRows,
                                   i1 - i0 - kStageRows)),
                 nid);
  for (long long s0 = i0; s0 < i1; s0 += kStageRows) {
    const int m = (int)min((long long)kStageRows, i1 - s0);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
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
    if (fl0 < nf) {
      for (int base = 0; base < m; base += 32 * G) {
        float2 own[G];
        unsigned cb[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int j = base + 32 * q + lane;
          own[q] = j < m ? sm.sgh[j] : make_float2(0.f, 0.f);
          cb[q] = sm.cbits[((base >> 5) + q) & (kStageGroups - 1)];
        }
        for (int fl = fl0; fl < nf; fl += fstep) {
          if constexpr (kFirst)
            add_groups_first<BinT, G>(sm.bin + fl * kStageRows, base, m, lane,
                                      sm.sgh, own, cb, sm.gh + (size_t)fl * B,
                                      sm.mc + (size_t)fl * B, lo, hi);
          else
            add_groups_mask<BinT, G>(sm.bin + fl * kStageRows, base, m, lane,
                                     sm.sgh, own, cb, sm.gh + (size_t)fl * B,
                                     sm.mc + (size_t)fl * B, lo, hi);
        }
      }
    }
  }
  __syncthreads();
}

template <typename BinT, bool kIds, int G, bool kSplit, bool kFirst>
__global__ void __launch_bounds__(kThreads)
kern_mask(const BinT* bins, const float* ghc, const int* ids,
          long long count, int F, int B, int tile, int chunks,
          double* partial, float* out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nft = (F + tile - 1) / tile;
  const int c = blockIdx.x / nft, f0 = (blockIdx.x % nft) * tile;
  const int nf = min(tile, F - f0);
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const MSmem<BinT> sm = mcarve<BinT>(dyn, tile, B);
  hist_chunk_mask<BinT, kIds, G, kSplit, kFirst>(ids, i0, i1, ghc, bins, F,
                                                 f0, nf, B, sm);
  const size_t off = (size_t)f0 * B * 3;
  double* dst = partial + (size_t)c * F * B * 3 + off;
  for (int i = threadIdx.x; i < nf * B * 3; i += kThreads) {
    const int k = i / 3, ch = i - 3 * k;
    const double v =
        ch == 0 ? sm.gh[k].x : ch == 1 ? sm.gh[k].y : (double)sm.mc[k].y;
    if (chunks == 1)
      out[off + i] = (float)v;
    else
      dst[i] = v;
  }
}

__global__ void reduce(const double* partial, int chunks, long long n,
                       float* out);

template <typename BinT, bool kIds, int G, bool kSplit, bool kFirst>
int run_mask(const void* bins, const float* ghc, const int* ids,
             long long count, int F, int B, int tile, int chunks,
             double* partial, float* out) {
  auto fn = kern_mask<BinT, kIds, G, kSplit, kFirst>;
  const size_t smem = mask_smem_bytes(sizeof(BinT), B, tile);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return (int)e;
  const int grid = chunks * ((F + tile - 1) / tile);
  fn<<<grid, kThreads, smem>>>(static_cast<const BinT*>(bins), ghc, ids,
                               count, F, B, tile, chunks, partial, out);
  e = cudaGetLastError();
  if (e) return (int)e;
  if (chunks > 1) {
    const long long n = (long long)F * B * 3;
    reduce<<<(unsigned)((n + 255) / 256), 256>>>(partial, chunks, n, out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT, bool kIds, int G, bool kPair, bool kOwn,
          bool kNoMatch, bool kNoRmw, bool kSplit, bool kAtomicCnt>
__device__ void hist_chunk(const int* ids, long long i0, long long i1,
                           const float* ghc, const BinT* bins, int F, int f0,
                           int nf, int B, const Smem<BinT>& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nf * B; i += kThreads) {
    sm.gh[i] = make_double2(0.0, 0.0);
    sm.cnt[i] = 0;
  }
  // warp -> features: fl = warp, warp + kWarps, ... (whole bin range);
  // or (split) kWarps / nf warps a feature, each a contiguous bin range
  int wpf = 1, fl0 = warp, fstep = kWarps, lo = 0, hi = B;
  if (kSplit && nf < kWarps) {
    wpf = kWarps / nf;
    fl0 = warp / wpf < nf ? warp / wpf : nf;  // surplus warps idle
    fstep = nf + 1;                           // one feature a warp
    const int part = warp % wpf, width = (B + wpf - 1) / wpf;
    lo = part * width;
    hi = min(B, lo + width);
  }
  double2 sink = make_double2(0.0, 0.0);
  Staged<BinT> st;
  int nid[kPer];
  load_ids<kIds>(ids, i0, (int)min((long long)kStageRows, i1 - i0), st.rid);
  load_rows(ghc, bins, F, f0, nf, st);
  load_ids<kIds>(ids, i0 + kStageRows,
                 (int)max(0LL, min((long long)kStageRows,
                                   i1 - i0 - kStageRows)),
                 nid);
  for (long long s0 = i0; s0 < i1; s0 += kStageRows) {
    const int m = (int)min((long long)kStageRows, i1 - s0);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
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
    if (fl0 < nf) {
      for (int base = 0; base < m; base += 32 * G) {
        float2 own[G];
        unsigned cb[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int j = base + 32 * q + lane;
          own[q] = j < m ? sm.sgh[j] : make_float2(0.f, 0.f);
          cb[q] = sm.cbits[(base >> 5) + q < kStageGroups ? (base >> 5) + q
                                                          : 0];
        }
        for (int fl = fl0; fl < nf; fl += fstep) {
          double2* gh = sm.gh + (size_t)fl * B;
          int* cnt = sm.cnt + (size_t)fl * B;
          add_groups<BinT, G, kPair, kOwn, kNoMatch, kNoRmw, kAtomicCnt>(
              sm.bin + fl * kStageRows, base, m, lane, sm.sgh, own, cb, gh,
              reinterpret_cast<double*>(gh), reinterpret_cast<double*>(gh) + B,
              cnt, lo, hi, sink);
        }
      }
    }
  }
  if constexpr (kNoRmw) {
    if (sink.x == 12345.678) sm.gh[0] = sink;
  }
  __syncthreads();
}

template <typename BinT, bool kIds, int G, bool kPair, bool kOwn,
          bool kNoMatch, bool kNoRmw, bool kSplit, bool kAtomicCnt>
__global__ void __launch_bounds__(kThreads)
kern(const BinT* bins, const float* ghc, const int* ids, long long count,
     int F, int B, int tile, int chunks, double* partial, float* out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nft = (F + tile - 1) / tile;
  const int c = blockIdx.x / nft, f0 = (blockIdx.x % nft) * tile;
  const int nf = min(tile, F - f0);
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const Smem<BinT> sm = carve<BinT>(dyn, tile, B);
  hist_chunk<BinT, kIds, G, kPair, kOwn, kNoMatch, kNoRmw, kSplit,
             kAtomicCnt>(ids, i0, i1, ghc, bins, F, f0, nf, B, sm);
  const size_t off = (size_t)f0 * B * 3;
  double* dst = partial + (size_t)c * F * B * 3 + off;
  for (int i = threadIdx.x; i < nf * B * 3; i += kThreads) {
    const int k = i / 3, ch = i - 3 * k;
    double v;
    if (kPair)
      v = ch == 0 ? sm.gh[k].x : ch == 1 ? sm.gh[k].y : (double)sm.cnt[k];
    else {
      const int fl = k / B, b = k - fl * B;
      const double* p = reinterpret_cast<const double*>(sm.gh + (size_t)fl * B);
      v = ch == 0 ? p[b] : ch == 1 ? p[B + b] : (double)sm.cnt[k];
    }
    if (chunks == 1)
      out[off + i] = (float)v;
    else
      dst[i] = v;
  }
}

__global__ void reduce(const double* partial, int chunks, long long n,
                       float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = partial[i];
  for (int c = 1; c < chunks; ++c) s += partial[c * n + i];
  out[i] = (float)s;
}

template <typename BinT, bool kIds>
int run_before(const void* bins, const float* ghc, const int* ids,
               long long count, int F, int B, int tile, int chunks,
               double* partial, float* out) {
  auto fn = before::kern<BinT, kIds>;
  const size_t smem = before::tile_smem_bytes(sizeof(BinT), B, tile);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return (int)e;
  const int grid = chunks * ((F + tile - 1) / tile);
  fn<<<grid, kThreads, smem>>>(static_cast<const BinT*>(bins), ghc, ids,
                               count, F, B, tile, chunks, partial, out);
  e = cudaGetLastError();
  if (e) return (int)e;
  if (chunks > 1) {
    const long long n = (long long)F * B * 3;
    reduce<<<(unsigned)((n + 255) / 256), 256>>>(partial, chunks, n, out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT, bool kIds, int G, bool kPair, bool kOwn,
          bool kNoMatch, bool kNoRmw, bool kSplit, bool kAtomicCnt>
int run(const void* bins, const float* ghc, const int* ids, long long count,
        int F, int B, int tile, int chunks, double* partial, float* out) {
  auto fn = kern<BinT, kIds, G, kPair, kOwn, kNoMatch, kNoRmw, kSplit,
                 kAtomicCnt>;
  const size_t smem = smem_bytes(sizeof(BinT), B, tile);
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = chunks * ((F + tile - 1) / tile);
  fn<<<grid, kThreads, smem>>>(static_cast<const BinT*>(bins), ghc, ids,
                               count, F, B, tile, chunks, partial, out);
  cudaError_t e = cudaGetLastError();
  if (e) return (int)e;
  if (chunks > 1) {
    const long long n = (long long)F * B * 3;
    reduce<<<(unsigned)((n + 255) / 256), 256>>>(partial, chunks, n, out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT, bool kIds, int G, bool kAtomicCnt>
int run_tag(const void* bins, const float* ghc, const int* ids,
            long long count, int F, int B, int tile, int chunks,
            double* partial, float* out) {
  auto fn = kern_tag<BinT, kIds, G, kAtomicCnt>;
  const size_t smem = smem_bytes(sizeof(BinT), B, tile) + 16 +
                      tag_bytes(B, tile, G);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return (int)e;
  const int grid = chunks * ((F + tile - 1) / tile);
  fn<<<grid, kThreads, smem>>>(static_cast<const BinT*>(bins), ghc, ids,
                               count, F, B, tile, chunks, partial, out);
  e = cudaGetLastError();
  if (e) return (int)e;
  if (chunks > 1) {
    const long long n = (long long)F * B * 3;
    reduce<<<(unsigned)((n + 255) / 256), 256>>>(partial, chunks, n, out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT, bool kIds>
int dispatch(int v, const void* bins, const float* ghc, const int* ids,
             long long count, int F, int B, int tile, int chunks,
             double* partial, float* out) {
#define R(...) return run<BinT, kIds, __VA_ARGS__>(bins, ghc, ids, count, F, \
                                                   B, tile, chunks, partial, \
                                                   out)
#define T(...) return run_tag<BinT, kIds, __VA_ARGS__>(bins, ghc, ids, count, \
                                                       F, B, tile, chunks, \
                                                       partial, out)
#define M(...) return run_mask<BinT, kIds, __VA_ARGS__>(bins, ghc, ids, \
                                                        count, F, B, tile, \
                                                        chunks, partial, out)
  // the lever ids of chip_hist_levers.py LEVERS
  switch (v) {
    case 0: return run_before<BinT, kIds>(bins, ghc, ids, count, F, B, tile,
                                          chunks, partial, out);
    // match: G, pair, own, no_match, no_rmw, split, atomic_cnt
    case 1: R(4, false, false, false, false, false, false);
    case 2: R(4, true, false, false, false, false, false);
    case 3: R(4, true, true, false, false, false, false);
    case 4: R(4, true, true, false, false, false, true);
    case 5: R(4, true, true, false, false, true, false);
    case 6: R(4, true, true, true, false, false, false);
    case 7: R(4, true, true, false, true, false, false);
    // tags: G, atomic_cnt
    case 8: T(4, true);
    // peer words: G, split, first lane leads
    case 9: M(4, false, false);
    case 10: M(2, false, false);
    case 11: M(8, false, false);
    case 12: M(4, true, false);
    case 13: M(4, false, true);
  }
#undef R
#undef T
#undef M
  return -1;
}
}  // namespace x

// lever v over the rows ids[0, count) (or rows [0, count) with no ids);
// bins [n, F] u8 (bb 1) or u16 (bb 2); out [F, B, 3] f32
extern "C" __attribute__((visibility("default"))) int levers_hist(
    int v, int bb, const void* bins, const float* ghc, const int* ids,
    long long count, int F, int B, int tile, int chunks, double* partial,
    float* out) {
  if (bb == 1)
    return ids ? x::dispatch<uint8_t, true>(v, bins, ghc, ids, count, F, B,
                                            tile, chunks, partial, out)
               : x::dispatch<uint8_t, false>(v, bins, ghc, ids, count, F, B,
                                             tile, chunks, partial, out);
  return ids ? x::dispatch<uint16_t, true>(v, bins, ghc, ids, count, F, B,
                                           tile, chunks, partial, out)
             : x::dispatch<uint16_t, false>(v, bins, ghc, ids, count, F, B,
                                            tile, chunks, partial, out);
}
