// Full-range histogram on Hopper: all rows of a bin matrix, or a list of
// row ids in row order.
//
// Replaces the TPU kernel histogram_pallas
// (lightgbm_tpu/ops/hist_pallas.py:642), the "pallas" method of
// build_histogram (lightgbm_tpu/ops/histogram.py:97-99), which builds
// the u8 training matrix on the fly and runs the segment histogram
// (histogram_segment :617, Pallas calls :569/:582/:305) over all of it.
// Computes the [F, B, 3] (sum grad, sum hess, count) f32 histogram of a
// row-major [N, F] bin matrix, u8 (B <= 256, all that the TPU function
// takes), u16 (B <= 32,768, the serial learner's bins held as int16
// bits) or u32 (B <= 65,536: past 32,768 bins the device copy is
// int32), with ghc [N, 3] f32, over
//  * all N rows (the serial learner's root histogram), or
//  * the rows ids[0, count) in row order (a per-phase split's smaller
//    child: the rows whose ghc the JAX learner masks to zero add
//    nothing, so the list is the same function).
// No training matrix is built: the bins and ghc are read where they lie.
//
// What bounds it on the H100: bytes, in principle -- each listed row's
// ghc (12 B) and bins (F or 2F B) once, the id (4 B) in list mode: 80 MB
// at 2M x 28 u8, 136 MB at u16, ~0.024 / 0.041 ms at 3.35 TB/s. In
// practice the SM's work on each (row, feature) pair of the float64
// accumulation of hist_ids.cuh: finding a 32-row group's lanes of one
// bin, and the scattered read-modify-writes of the tile's bins in
// shared memory. The loop finds the lanes with integer atomics on a
// peer word a bin instead of __match_any_sync (hist_ids.cuh), with g
// and h one double2 and the count an integer.
//
// Design: the row loop of the leaf fused step (hist_ids.cuh), so a
// per-phase child's histogram equals the fused step's histogram of the
// same rows bit for bit. One launch of (chunk, feature tile) blocks, the
// chunks cut from count, F and the leaf kernel's feature tile alone
// (child_chunks, max_chunks_of), one block each, 256 threads; the tile
// and the shared memory are the leaf kernel's (the host passes
// leaf_feat_tile). A list of one chunk is rounded and written straight
// to out; otherwise each block writes its float64 partial and a second
// kernel sums the partials in chunk order and rounds once, as the fused
// step's reduce does. All-rows mode computes row = position and reads no
// list. No float atomics: bitwise reproducible, on any card. The count
// channel is counted, not summed: the rows whose count is not 0 (ghc's
// count is a 0/1 indicator, so the two are the same number).
//
// Past 1024 bins the tile rule (leaf_feat_tile) gives one feature a
// tile from ~4,400 bins on, and its bins take more than the leaf
// kernel's 110 KB (one block an SM). Past the bins whose one-feature
// tile fits a block's 227 KB (~9,400), each block takes one window of
// a feature's bins (bin_window): blocks are (chunk, feature tile,
// window), each reads its chunk's rows and adds the rows of its window
// only. The chunks are cut as before (windows do not enter
// max_chunks_of), and a bin's float64 sum has the same adds in the same
// order whatever the windows.
//
// out64, when given, takes the float64 sums unrounded instead of the
// float32 out (the data-parallel learners reduce them across ranks
// before their one rounding).
//
// A second instantiation (kTimed, launched by chip_profile.py only) has
// thread 0 of every block record its clock64 laps of hist_chunk.
//
// ltt_hist_rows_batched (the multiboost learner's root histograms: the
// JAX package vmaps this function along a model axis) takes all rows
// for M models' ghc at once, each model's result this kernel's bit for
// bit, the peers of a row group found once for all the block's models;
// see the note above hist_rows_batched_kernel.
#include "common.cuh"
#include "hist_ids.cuh"

namespace {

using ltt::ids::kFull;
using ltt::ids::kThreads;
// a block's dynamic shared memory, at most (the H100's 227 KB)
constexpr size_t kMaxSmem = 232448;

// The window of bins a block takes: all B bins when the tile fits
// kMaxSmem, else the most bins of one feature that do.
inline int bin_window(int bin_bytes, int B, int feat_tile) {
  if (ltt::ids::tile_smem_bytes(bin_bytes, B, feat_tile) <= kMaxSmem)
    return B;
  if (feat_tile != 1) return 0;
  const size_t fixed = ltt::ids::tile_smem_bytes(bin_bytes, 0, 1);
  return (int)((kMaxSmem - fixed) / ltt::ids::kBinBytes);
}

template <typename BinT, bool kIds, bool kTimed>
__global__ void __launch_bounds__(kThreads)
hist_rows_kernel(const BinT* __restrict__ bins, const float* __restrict__ ghc,
                 const int* __restrict__ ids, long long count, int F, int B,
                 int feat_tile, int chunks, int win,
                 double* __restrict__ partial, float* __restrict__ out,
                 double* __restrict__ out64, unsigned long long* times) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nft = ltt::ids::feature_tiles(F, feat_tile);
  const int nwin = (B + win - 1) / win;
  const int c = blockIdx.x / (nft * nwin);
  const int r = blockIdx.x % (nft * nwin);
  const int f0 = (r / nwin) * feat_tile, lo = (r % nwin) * win;
  const int nf = min(feat_tile, F - f0);
  const int nb = min(win, B - lo);  // this block's bins [lo, lo + nb)
  const int n3 = nf * nb * 3;
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const ltt::ids::TileSmem<BinT> tile =
      ltt::ids::carve<BinT>(dyn, feat_tile, win);
  ltt::ids::Laps<kTimed> clk;
  clk.start();
  ltt::ids::hist_chunk<BinT, kIds, kTimed, true>(ids, i0, i1, ghc, bins, F,
                                                 f0, nf, nb, tile, clk, lo);
  // tile element i = (feature f0 + i / (3 nb), bin lo + i / 3 % nb, i % 3)
  auto dst_of = [&](int i) {
    const int k = i / 3, fl = k / nb;
    return ((size_t)(f0 + fl) * B + lo + (k - fl * nb)) * 3 + (i - 3 * k);
  };
  if (chunks == 1 && out64 != nullptr) {
    for (int i = threadIdx.x; i < n3; i += kThreads)
      out64[dst_of(i)] = ltt::ids::tile_value(tile, i);
  } else if (chunks == 1) {
    for (int i = threadIdx.x; i < n3; i += kThreads)
      out[dst_of(i)] = (float)ltt::ids::tile_value(tile, i);
  } else {
    double* dst = partial + (size_t)c * F * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads)
      dst[dst_of(i)] = ltt::ids::tile_value(tile, i);
  }
  if constexpr (kTimed) {
    clk.lap(3);
    if (threadIdx.x == 0)
      for (int i = 0; i < 4; ++i)
        times[(size_t)blockIdx.x * 4 + i] = clk.acc[i];
  }
}

// out[i] = the chunks' partials summed in chunk order, rounded once (or
// into out64 unrounded)
__global__ void hist_rows_reduce(const double* __restrict__ partial,
                                 int chunks, long long n,
                                 float* __restrict__ out,
                                 double* __restrict__ out64) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = partial[i];
  for (int c = 1; c < chunks; ++c) s += partial[c * n + i];
  if (out64 != nullptr)
    out64[i] = s;
  else
    out[i] = (float)s;
}

template <typename BinT, bool kIds, bool kTimed>
int launch(const void* bins, const float* ghc, const int* ids,
           long long count, int F, int B, int feat_tile, int chunks,
           int win, double* partial, float* out, double* out64,
           unsigned long long* times, size_t smem, cudaStream_t stream) {
  // the attribute is set once per instance and size, not per launch
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_rows_kernel<BinT, kIds, kTimed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = chunks * ltt::ids::feature_tiles(F, feat_tile) *
                   ((B + win - 1) / win);
  hist_rows_kernel<BinT, kIds, kTimed><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), ghc, ids, count, F, B, feat_tile,
      chunks, win, partial, out, out64, times);
  return (int)cudaGetLastError();
}

template <typename BinT, bool kTimed>
int launch_ids(const void* bins, const float* ghc, const int* ids,
               long long count, int F, int B, int feat_tile, int chunks,
               int win, double* partial, float* out, double* out64,
               unsigned long long* times, size_t smem,
               cudaStream_t stream) {
  return ids ? launch<BinT, true, kTimed>(bins, ghc, ids, count, F, B,
                                          feat_tile, chunks, win, partial,
                                          out, out64, times, smem, stream)
             : launch<BinT, false, kTimed>(bins, ghc, ids, count, F, B,
                                           feat_tile, chunks, win, partial,
                                           out, out64, times, smem, stream);
}

template <bool kTimed>
int hist_rows(int bin_bytes, const void* bins, const float* ghc,
              const int* ids, long long count, int F, int B, int feat_tile,
              int max_chunks, double* partial, float* out, double* out64,
              unsigned long long* times, cudaStream_t stream) {
  const int max_b = bin_bytes == 1 ? 256 : bin_bytes == 2 ? 32768 : 65536;
  if (F < 1 || B < 1 || count < 0 || feat_tile < 1 ||
      feat_tile > ltt::ids::kMaxTile || B > max_b ||
      (bin_bytes != 1 && bin_bytes != 2 && bin_bytes != 4) ||
      max_chunks != ltt::ids::max_chunks_of(F, feat_tile) ||
      (kTimed && times == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = ltt::ids::child_chunks(count, max_chunks);
  if (chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int win = bin_window(bin_bytes, B, feat_tile);
  if (win < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ltt::ids::tile_smem_bytes(bin_bytes, win, feat_tile);
  int err;
  if (bin_bytes == 1)
    err = launch_ids<uint8_t, kTimed>(bins, ghc, ids, count, F, B,
                                      feat_tile, chunks, win, partial, out,
                                      out64, times, smem, stream);
  else if (bin_bytes == 2)
    err = launch_ids<uint16_t, kTimed>(bins, ghc, ids, count, F, B,
                                       feat_tile, chunks, win, partial, out,
                                       out64, times, smem, stream);
  else
    err = launch_ids<uint32_t, kTimed>(bins, ghc, ids, count, F, B,
                                       feat_tile, chunks, win, partial, out,
                                       out64, times, smem, stream);
  if (err || chunks == 1) return err;
  const long long n = (long long)F * B * 3;
  hist_rows_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, chunks, n, out, out64);
  return (int)cudaGetLastError();
}

// ---- the model-batched histogram of all rows -------------------------
// ltt_hist_rows_batched: the [F, B, 3] histograms of all N rows of one
// bin matrix for M models' ghc [M, N, 3] (the roots of a bucket of
// models). Each model's histogram is ltt_hist_rows' of its ghc, bit for
// bit: the same chunks (child_chunks of N with the leaf kernel's feature
// tile), every bin's float64 sum over the same 32-row groups in the same
// order, one add a group of the group's rows of that bin summed in lane
// order from 0 (add_groups' adds, hist_ids.cuh), the same partials
// summed in chunk order and rounded once. Which features and models a
// block holds does not enter a sum.
//
// What bounds it on the H100: the SM's shared-memory work a (row,
// feature, model), not bytes (~0.05 ms of the bins once and 12 B of ghc
// a row a model at 2M x 28 u8, B 4). hist_rows does, for each (row,
// feature), the peer search of add_groups (an OR into the bin's peer
// word, its read back, the leader's clear, three warp syncs) and the
// leader's adds; a loop of B hist_rows launches, or a block that runs
// add_groups once a (model, feature), does both B times, though the
// peers depend on the bins alone and the bins are every model's.
//
// Design: a block takes a sub-tile of ft features and mb models (up to
// kBMaxTile and kBMaxModels) of one chunk and walks its rows in steps of
// kBStep, one row a thread:
//  * staging, pipelined: each thread holds its next row's ft bins and
//    every model's (g, h, count) in registers (BStaged); at a step it
//    stores them (the bins once, each model's (g, h) and a ballot of its
//    count bits) and issues the next step's loads, which land while this
//    step is summed;
//  * pass 1, the peers, once for all mb models: (feature, 32-row group)
//    units over the warps, each warp with its own peer word a bin: the
//    lanes OR their bits into their bins' words and read them back; the
//    lowest lane of a word leads, writes (peers, bin) to its row's slot
//    of the leader table, adds the peers' popcount to the feature's row
//    count of the bin and clears the word;
//  * pass 2, the adds: (pair of models, feature) units over the warps,
//    each walking the step's groups in order: a leader adds its peers'
//    (g, h) from each model's stage in lane order (its own first, a
//    coalesced load) into the model's double2, and counts its peers
//    whose count is 0 into the model's missing count (rare: out-of-bag
//    or zero-weight rows); the pair's two read-modify-writes are
//    independent, so two are in flight. A bin's count is the rows of the
//    bin less the missing ones: the same integer as the popcount of the
//    count bits.
// A block's shape (batched_shape) is the most models (up to kBMaxModels,
// spread evenly over the fewest groups) and then the widest feature
// sub-tile whose shared memory leaves two blocks an SM; at 2M rows the
// chunk cap (128 chunks at F 28) gives 3 or more blocks an SM slot.
constexpr int kBStep = kThreads;          // rows a step, one a thread
constexpr int kBGroups = kBStep / 32;     // 32-row groups a step
constexpr int kBMaxModels = 8;            // models a block, at most
constexpr int kBMaxTile = 8;              // features a block, at most
constexpr int kBWarps = kThreads / 32;
// shared bytes of a block, at most: two blocks an SM (the H100's 228 KB
// an SM, 1 KB of it reserved a block)
constexpr size_t kBatchedSmem = 113 * 1024;
// bytes a bin: a model's double2 (g, h) and missing count; a feature's
// row count; each warp's peer word
constexpr int kBModelBinBytes = 20;
constexpr int kBFeatureBinBytes = 4;
constexpr int kBWarpBinBytes = 4;
// bytes a step row: a feature's leader slot (uint2: peers, bin); a
// model's staged (g, h)
constexpr int kBLeaderBytes = 8;
constexpr int kBStageRowBytes = 8;

// shared bytes of a block of ft features and mb models
inline size_t batched_smem(int bin_bytes, int B, int ft, int mb) {
  return (size_t)mb * ft * B * kBModelBinBytes +
         (size_t)ft * B * kBFeatureBinBytes +
         (size_t)kBWarps * B * kBWarpBinBytes +
         (size_t)ft * kBStep * kBLeaderBytes +
         (size_t)mb * (kBStep * kBStageRowBytes + kBGroups * 4) +
         (size_t)ft * kBStep * bin_bytes;
}

// (features a block, models a block) for M models: the models spread
// evenly over the fewest groups of at most kBMaxModels, then the widest
// sub-tile (at most the leaf kernel's tile and kBMaxTile) that fits
// kBatchedSmem; more groups while not even one feature fits. 0 models:
// no shape fits.
inline void batched_shape(int bin_bytes, int B, int feat_tile, int models,
                          int* ft_out, int* mb_out) {
  const int cap = feat_tile < kBMaxTile ? feat_tile : kBMaxTile;
  for (int groups = (models + kBMaxModels - 1) / kBMaxModels;; ++groups) {
    const int mb = (models + groups - 1) / groups;
    for (int ft = cap; ft >= 1; --ft)
      if (batched_smem(bin_bytes, B, ft, mb) <= kBatchedSmem) {
        *ft_out = ft;
        *mb_out = mb;
        return;
      }
    if (mb == 1) {
      *ft_out = 1;
      *mb_out = 0;
      return;
    }
  }
}

// the timed instantiation's laps a block (thread 0's clock64): first
// fetch (zeroing, the first loads issued), stage (the stores, waiting on
// the loads), peers (pass 1), adds (pass 2), write-out
constexpr int kBatchedLaps = 5;

template <bool kTimed>
struct BLaps {
  unsigned long long t = 0, acc[kBatchedLaps] = {};
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

// One thread's next row: its ft bins and each model's (g, h, count).
template <typename BinT>
struct BStaged {
  float g[kBMaxModels], h[kBMaxModels], c[kBMaxModels];
  BinT bin[kBMaxTile];
};

template <typename BinT>
__device__ __forceinline__ void bload(const BinT* bins, const float* ghc,
                                      long long n, int F, int f0, int nf,
                                      int m0, int nm, long long row,
                                      BStaged<BinT>& st) {
  const BinT* rp = bins + (size_t)row * F + f0;
#pragma unroll
  for (int fl = 0; fl < kBMaxTile; ++fl)
    if (fl < nf) st.bin[fl] = rp[fl];
#pragma unroll
  for (int mm = 0; mm < kBMaxModels; ++mm)
    if (mm < nm) {
      const float* gp = ghc + ((size_t)(m0 + mm) * n + row) * 3;
      st.g[mm] = gp[0];
      st.h[mm] = gp[1];
      st.c[mm] = gp[2];
    }
}

template <typename BinT, bool kTimed>
__global__ void __launch_bounds__(kThreads, 2)
hist_rows_batched_kernel(const BinT* __restrict__ bins,
                         const float* __restrict__ ghc, long long n, int F,
                         int B, int models, int ft, int mb, int chunks,
                         int max_chunks, double* __restrict__ partial,
                         float* __restrict__ out,
                         unsigned long long* times) {
  BLaps<kTimed> clk;
  clk.start();
  extern __shared__ __align__(16) unsigned char dyn[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nft = (F + ft - 1) / ft;
  const int ngroups = (models + mb - 1) / mb;
  const int c = blockIdx.x / (nft * ngroups);
  const int r = blockIdx.x % (nft * ngroups);
  const int f0 = (r / ngroups) * ft, m0 = (r % ngroups) * mb;
  const int nf = min(ft, F - f0), nm = min(mb, models - m0);
  const long long chunk = (n + chunks - 1) / chunks;
  const long long i0 = min(n, (long long)c * chunk);
  const long long i1 = min(n, i0 + chunk);
  // [mb][ft][B] double2 (g, h); [mb][kBStep] staged (g, h); [ft][kBStep]
  // leader slots (peers, bin); [mb][ft][B] missing counts; [ft][B] row
  // counts; [kBWarps][B] peer words; [mb][kBGroups] count bits;
  // [ft][kBStep] staged bins (the 8-byte arrays first)
  const int tb = ft * B;
  double2* gh = reinterpret_cast<double2*>(dyn);
  float2* sgh = reinterpret_cast<float2*>(gh + (size_t)mb * tb);
  uint2* lead = reinterpret_cast<uint2*>(sgh + (size_t)mb * kBStep);
  unsigned* miss = reinterpret_cast<unsigned*>(lead + (size_t)ft * kBStep);
  unsigned* rows = miss + (size_t)mb * tb;
  unsigned* pw = rows + tb;
  unsigned* cbits = pw + (size_t)kBWarps * B;
  BinT* sbin = reinterpret_cast<BinT*>(cbits + (size_t)mb * kBGroups);
  for (int i = threadIdx.x; i < mb * tb; i += kThreads) {
    gh[i] = make_double2(0.0, 0.0);
    miss[i] = 0u;
  }
  for (int i = threadIdx.x; i < tb; i += kThreads) rows[i] = 0u;
  for (int i = threadIdx.x; i < kBWarps * B; i += kThreads) pw[i] = 0u;
  BStaged<BinT> st;
  if (i0 + threadIdx.x < i1)
    bload(bins, ghc, n, F, f0, nf, m0, nm, i0 + threadIdx.x, st);
  clk.lap(0);
  for (long long s0 = i0; s0 < i1; s0 += kBStep) {
    const int m = (int)min((long long)kBStep, i1 - s0);
    __syncthreads();  // the last step's passes are done (the tiles zeroed)
    clk.lap(3);
    {
      const int j = threadIdx.x;
      const bool ok = j < m;
#pragma unroll
      for (int fl = 0; fl < kBMaxTile; ++fl)
        if (fl < nf && ok) sbin[fl * kBStep + j] = st.bin[fl];
#pragma unroll
      for (int mm = 0; mm < kBMaxModels; ++mm)
        if (mm < nm) {
          const unsigned bits = __ballot_sync(kFull, ok && st.c[mm] != 0.0f);
          if (lane == 0) cbits[mm * kBGroups + warp] = bits;
          if (ok) sgh[mm * kBStep + j] = make_float2(st.g[mm], st.h[mm]);
        }
    }
    __syncthreads();
    clk.lap(1);
    // the next step's rows load while this step is summed
    const long long s1 = s0 + kBStep;
    if (s1 + threadIdx.x < i1)
      bload(bins, ghc, n, F, f0, nf, m0, nm, s1 + threadIdx.x, st);
    // pass 1: the peers of each (feature, group), once for all models
    unsigned* own = pw + (size_t)warp * B;
    for (int u = warp; u < nf * kBGroups; u += kBWarps) {
      const int fl = u / kBGroups, q = u - fl * kBGroups;
      const int j = 32 * q + lane;
      const int b = j < m ? (int)sbin[fl * kBStep + j] : -1;
      if (b >= 0) atomicOr(&own[b], 1u << lane);
      __syncwarp();
      const unsigned w = b >= 0 ? own[b] : 0u;
      __syncwarp();  // every lane's read lands before its leader clears
      const bool leads = b >= 0 && (w & ((1u << lane) - 1u)) == 0u;
      lead[fl * kBStep + j] = make_uint2(leads ? w : 0u, (unsigned)b);
      if (leads) {
        // warps share a feature's row counts: integer atomics
        atomicAdd(&rows[fl * B + b], (unsigned)__popc(w));
        own[b] = 0u;
      }
      __syncwarp();  // the clears land before the next unit's ORs
    }
    __syncthreads();
    clk.lap(2);
    // pass 2: the adds of (model pair, feature) units, groups in row
    // order; the pair's two chains are independent (two models' loads
    // and adds in flight), and each lane's own (g, h), its row's, loads
    // coalesced: a leader is its peers' lowest lane, so its own comes
    // first in lane order
    const int pairs = (nm + 1) >> 1;
    for (int u = warp; u < pairs * nf; u += kBWarps) {
      const int pp = u / nf, fl = u - pp * nf;
      const int ma = 2 * pp;
      const bool two = ma + 1 < nm;  // uniform over the unit
      const int mb2 = two ? ma + 1 : ma;
      const float2* sa = sgh + (size_t)ma * kBStep;
      const float2* sb = sgh + (size_t)mb2 * kBStep;
      double2* ga = gh + (size_t)ma * tb + (size_t)fl * B;
      double2* gb = gh + (size_t)mb2 * tb + (size_t)fl * B;
      unsigned* xa = miss + (size_t)ma * tb + (size_t)fl * B;
      unsigned* xb = miss + (size_t)mb2 * tb + (size_t)fl * B;
      const uint2* ld = lead + fl * kBStep;
      for (int q = 0; q < kBGroups && 32 * q < m; ++q) {
        const int j = 32 * q + lane;
        const uint2 e = ld[j];
        if (e.x != 0u) {
          const float2 oa = sa[j];
          double g1 = 0.0, h1 = 0.0, g2 = 0.0, h2 = 0.0;
          g1 += (double)oa.x;
          h1 += (double)oa.y;
          float2 ob = oa;
          if (two) {
            ob = sb[j];
            g2 += (double)ob.x;
            h2 += (double)ob.y;
          }
          for (unsigned pm = e.x & (e.x - 1u); pm; pm &= pm - 1u) {
            const int p = 32 * q + __ffs(pm) - 1;
            const float2 va = sa[p];
            g1 += (double)va.x;
            h1 += (double)va.y;
            if (two) {
              const float2 vb = sb[p];
              g2 += (double)vb.x;
              h2 += (double)vb.y;
            }
          }
          double2 da = ga[e.y];
          double2 db = two ? gb[e.y] : da;
          da.x += g1;
          da.y += h1;
          ga[e.y] = da;
          const unsigned na = e.x & ~cbits[ma * kBGroups + q];
          if (na) xa[e.y] += __popc(na);
          if (two) {
            db.x += g2;
            db.y += h2;
            gb[e.y] = db;
            const unsigned nb = e.x & ~cbits[mb2 * kBGroups + q];
            if (nb) xb[e.y] += __popc(nb);
          }
        }
        __syncwarp();  // this group's adds land before the next group's
      }
    }
  }
  __syncthreads();
  clk.lap(3);
  // model mm's tile element i = (feature f0 + i / (3 B), bin i / 3 % B,
  // channel i % 3): the channels as hist_rows writes them
  const size_t fb3 = (size_t)F * B * 3;
  const size_t off = (size_t)f0 * B * 3;
  const int n3 = nf * B * 3;
  for (int mm = 0; mm < nm; ++mm) {
    const size_t dst = (chunks == 1 ? (size_t)(m0 + mm)
                                    : (size_t)(m0 + mm) * max_chunks + c) *
                           fb3 +
                       off;
    for (int i = threadIdx.x; i < n3; i += kThreads) {
      const int k = i / 3, ch = i - 3 * k;
      const double2 d = gh[(size_t)mm * tb + k];
      const double v = ch == 0   ? d.x
                       : ch == 1 ? d.y
                                 : (double)(rows[k] - miss[(size_t)mm * tb + k]);
      if (chunks == 1)
        out[dst + i] = (float)v;
      else
        partial[dst + i] = v;
    }
  }
  if constexpr (kTimed) {
    clk.lap(4);
    if (threadIdx.x == 0)
      for (int i = 0; i < kBatchedLaps; ++i)
        times[(size_t)blockIdx.x * kBatchedLaps + i] = clk.acc[i];
  }
}

// out[m][i] = model m's partials summed in chunk order, rounded once
__global__ void hist_rows_batched_reduce(const double* __restrict__ partial,
                                         int chunks, int max_chunks,
                                         long long fb3, long long total,
                                         float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long m = i / fb3, e = i - m * fb3;
  const double* p = partial + m * max_chunks * fb3 + e;
  double s = p[0];
  for (int c = 1; c < chunks; ++c) s += p[c * fb3];
  out[i] = (float)s;
}

template <typename BinT, bool kTimed>
int launch_batched(const void* bins, const float* ghc, long long n, int F,
                   int B, int models, int ft, int mb, int chunks,
                   int max_chunks, double* partial, float* out, size_t smem,
                   unsigned long long* times, cudaStream_t stream) {
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_rows_batched_kernel<BinT, kTimed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = chunks * ((F + ft - 1) / ft) * ((models + mb - 1) / mb);
  hist_rows_batched_kernel<BinT, kTimed><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), ghc, n, F, B, models, ft, mb, chunks,
      max_chunks, partial, out, times);
  return (int)cudaGetLastError();
}

template <bool kTimed>
int hist_rows_batched(int bin_bytes, const void* bins, const float* ghc,
                      long long n, int models, int F, int B, int feat_tile,
                      int max_chunks, double* partial, float* out,
                      unsigned long long* times, cudaStream_t stream) {
  if (F < 1 || B < 1 || B > 1024 || n < 0 || models < 1 || feat_tile < 1 ||
      feat_tile > ltt::ids::kMaxTile ||
      (bin_bytes == 1 && B > 256) || (bin_bytes != 1 && bin_bytes != 2) ||
      max_chunks != ltt::ids::max_chunks_of(F, feat_tile) ||
      (kTimed && times == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = ltt::ids::child_chunks(n, max_chunks);
  if (chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  int ft, mb;
  batched_shape(bin_bytes, B, feat_tile, models, &ft, &mb);
  if (mb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = batched_smem(bin_bytes, B, ft, mb);
  const int err =
      bin_bytes == 1
          ? launch_batched<uint8_t, kTimed>(bins, ghc, n, F, B, models, ft,
                                            mb, chunks, max_chunks, partial,
                                            out, smem, times, stream)
          : launch_batched<uint16_t, kTimed>(bins, ghc, n, F, B, models, ft,
                                             mb, chunks, max_chunks, partial,
                                             out, smem, times, stream);
  if (err || chunks == 1) return err;
  const long long fb3 = (long long)F * B * 3, total = fb3 * models;
  hist_rows_batched_reduce<<<(unsigned)((total + 255) / 256), 256, 0,
                             stream>>>(partial, chunks, max_chunks, fb3,
                                       total, out);
  return (int)cudaGetLastError();
}

}  // namespace

// bins [n, F] u8 (bin_bytes 1), u16 (2) or u32 (4); ghc [n, 3] f32;
// ids: count int32 row ids in row order, or null for rows [0, count)
// (count = n); feat_tile: the leaf kernel's (leaf_feat_tile);
// max_chunks = max_chunks_of(F, feat_tile); partial [max_chunks, F, B,
// 3] f64 (used when the call takes more than one chunk); out [F, B, 3]
// f32, or with out64 (not null) [F, B, 3] f64 sums, unrounded.
LTT_EXPORT int ltt_hist_rows(int bin_bytes, const void* bins,
                             const float* ghc, const int* ids,
                             long long count, int F, int B, int feat_tile,
                             int max_chunks, double* partial, float* out,
                             double* out64, cudaStream_t stream) {
  return hist_rows<false>(bin_bytes, bins, ghc, ids, count, F, B, feat_tile,
                          max_chunks, partial, out, out64, nullptr, stream);
}

// The timed instantiation (chip_profile.py only): the same histogram,
// and thread 0 of every block writes its cycles into times (u64
// [grid, 4]: first fetch, stores, accumulation, write-out; the Laps of
// hist_ids.cuh hist_chunk).
LTT_EXPORT int ltt_hist_rows_timed(int bin_bytes, const void* bins,
                                   const float* ghc, const int* ids,
                                   long long count, int F, int B,
                                   int feat_tile, int max_chunks,
                                   double* partial, float* out,
                                   unsigned long long* times,
                                   cudaStream_t stream) {
  return hist_rows<true>(bin_bytes, bins, ghc, ids, count, F, B, feat_tile,
                         max_chunks, partial, out, nullptr, times, stream);
}

// The window of bins one block of ltt_hist_rows takes (the grid has
// ceil(B / window) blocks a chunk and feature tile); 0 when no window
// fits.
LTT_EXPORT int ltt_hist_rows_window(int bin_bytes, int B, int feat_tile) {
  return bin_window(bin_bytes, B, feat_tile);
}

// The model-batched histogram of all rows: bins [n, F] u8 (bin_bytes 1)
// or u16 (2) with B <= 1024 (the leaf kernel's bins); ghc [models, n, 3]
// f32; feat_tile: the leaf kernel's (leaf_feat_tile); max_chunks =
// max_chunks_of(F, feat_tile); partial [models, max_chunks, F, B, 3]
// f64 (used when n takes more than one chunk); out [models, F, B, 3]
// f32, model m's equal to ltt_hist_rows of ghc[m] over all rows.
LTT_EXPORT int ltt_hist_rows_batched(int bin_bytes, const void* bins,
                                     const float* ghc, long long n,
                                     int models, int F, int B, int feat_tile,
                                     int max_chunks, double* partial,
                                     float* out, cudaStream_t stream) {
  return hist_rows_batched<false>(bin_bytes, bins, ghc, n, models, F, B,
                                  feat_tile, max_chunks, partial, out,
                                  nullptr, stream);
}

// The timed instantiation (chip_profile.py only): the same histograms,
// and thread 0 of every block writes its cycles into times (u64 [grid,
// 5]: first fetch, stage, peers, adds, write-out).
LTT_EXPORT int ltt_hist_rows_batched_timed(int bin_bytes, const void* bins,
                                           const float* ghc, long long n,
                                           int models, int F, int B,
                                           int feat_tile, int max_chunks,
                                           double* partial, float* out,
                                           unsigned long long* times,
                                           cudaStream_t stream) {
  return hist_rows_batched<true>(bin_bytes, bins, ghc, n, models, F, B,
                                 feat_tile, max_chunks, partial, out, times,
                                 stream);
}

// The batched launch's blocks: out[0] features a block, out[1] models a
// block, out[2] its dynamic shared bytes (for the byte and work counts
// of chip_smoke.py).
LTT_EXPORT int ltt_hist_rows_batched_shape(int bin_bytes, int B,
                                           int feat_tile, int models,
                                           int* out) {
  int ft, mb;
  batched_shape(bin_bytes, B, feat_tile, models, &ft, &mb);
  out[0] = ft;
  out[1] = mb;
  out[2] = (int)batched_smem(bin_bytes, B, ft, mb);
  return mb < 1 ? (int)cudaErrorInvalidValue : 0;
}
