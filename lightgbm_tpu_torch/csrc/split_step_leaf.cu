// One whole split of the serial (leaf_id) grow loop as one launch on
// Hopper.
//
// Replaces the TPU kernel fused_split_step_leaf
// (lightgbm_tpu/ops/split_step_pallas.py:413: Mosaic body
// _leaf_kernel_tpu :1091, interpret twin _leaf_kernel_ref :211). One
// launch does the whole split on the leaf_id[N] layout: pick the best
// open leaf from S, send the leaf's right-going rows to the new leaf in
// leaf_id (rows_go_left semantics, missing codes included), build the
// smaller child's histogram from the same rows, get the sibling as
// parent - child, scan both children, and write both S columns, the T
// column (with the parent-pointer fixup) and both rows of the per-leaf
// histogram cache. As in split_step_segment.cu, k lives on the device:
// the kernel reads it, checks the grow loop's condition (k < L and the
// best open gain > 0; lightgbm_tpu/learner/serial.py:1035-1041) and
// increments it, and changes nothing when the condition fails, so the
// host enqueues all L - 1 launches of a tree without reading anything.
//
// Layouts: S [Ks, L], T [9, L - 1] f32 (split_state.cuh, no prefix
// rows); lid [N] i32; hist [L, F, B, 3] f32; bins [N, F] row-major,
// u8 (B <= 256) or u16 (B <= 1024: the TPU body's u8 / 192-feature
// scope is a Mosaic limit, not the function's; the interpret twin takes
// any B); ghc [N, 3] f32 (grad, hess, count).
//
// What bounds it on the H100: memory traffic. A split must read lid for
// every row (the layout's O(N) per split: 8 MB at 2M rows whatever the
// leaf's size), write the leaf's right-going rows' lid, read the split
// feature's bin of the leaf's rows and the smaller child's bins and
// ghc, and read one cache row and write two. Past the lid pass, every
// phase's work scales with the smaller child's row count sc, not with
// N: the child's row ids are compacted once, and the histogram, its
// partials and their reduce are sized by sc.
//
// Design: one cooperative launch (grid from the occupancy API, every
// block resident), cooperative_groups grid syncs between the phases:
//  0. every block reads the split site (split_state.cuh);
//  1. the lid pass: each block walks its own contiguous range of about
//     N / grid rows (coalesced lid reads, kLidUnroll rows a thread in
//     flight); a row of the leaf decides its side from the split
//     feature's bin, right-going rows get lid = new, a warp ballot
//     writes the smaller child's membership bits, and each block writes
//     its member count | sync;
//  2. compaction: each block takes its offset from the block counts and
//     writes its members' row ids, in row order, to ids[0, sc) (one
//     coalesced read of its own mask words) | sync. Membership is fixed
//     here, once: no later phase reads a lid another block may write;
//  3. the histogram over ids: (chunk, feature tile) virtual blocks, the
//     chunks cut from sc alone (kChunkRows rows each, at most
//     kMaxVBlocks / tiles of them), so the summation order does not
//     depend on the card. A virtual block stages kStageRows rows' ghc
//     and tile bins in shared memory through the id list (independent
//     loads in flight), then warp w owns features w, w + 8, ... of the
//     tile; __match_any_sync groups the lanes that hit one bin and the
//     lowest lane adds its peers in lane order, two 32-row groups in
//     flight. Sums are float64 in shared memory, so a bin's sum depends
//     on the row order alone. A child of one chunk (sc <= kChunkRows)
//     writes its rounded child row and parent - child straight into the
//     cache; otherwise each chunk writes a float64 partial | sync;
//  4. (more than one chunk) partials summed in chunk order in float64
//     and rounded once (as the plain histogram, ops/histogram.py,
//     accumulates in float64 and rounds once); sibling = parent - child
//     in float32; both cache rows written | sync;
//  5. both children's scans (scan_core.cuh), one virtual block per
//     (child, feature); each block then counts itself done;
//  6. the last block to count: both S columns, the T column, k + 1
//     (split_state.cuh), and the count back to 0 for the next launch.
// No float atomics: the result is bitwise reproducible, on any card.
// Data written by another block in this launch is read with __ldcg (L2,
// not a possibly stale L1 line). Compiled with -fmad=false: the scan,
// the leaf outputs and the subtraction follow the plain version's
// float32 expression order.
//
// A second instantiation (kTimed, launched by chip_profile.py only)
// has block 0 record %globaltimer and clock64 after each phase.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "partition_core.cuh"
#include "scan_core.cuh"
#include "split_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLidUnroll = 16;     // rows a thread keeps in flight (lid pass)
constexpr int kStageRows = 512;    // child rows staged per step
constexpr int kPer = kStageRows / kThreads;  // staged rows per thread
constexpr int kMaxTile = 16;       // features per histogram tile, at most
constexpr int kChunkRows = 512;    // child rows per histogram chunk
constexpr int kMaxVBlocks = 256;   // cap of chunks x feature tiles
constexpr int kGroups = 4;         // 32-row groups a warp has in flight
constexpr int kTimes = 32;         // clock reads per split (timed build)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int* k;  // device int32[1]: the split index (= the new leaf's id)
  float* S;
  float* T;
  int* lid;
  float* hist;
  const void* bins;  // [N, F] u8 or u16
  const float* ghc;  // [N, 3]
  const int* imeta;
  const float* fmeta;
  double* partial;  // [max_chunks, F, B, 3]
  unsigned* mask;   // [ceil(N / 32)] smaller-child membership bits
  int* ids;         // [N] the smaller child's row ids, row order
  int* counts;      // [grid] members per block
  float* table;     // [2, F, 8] scan tables of the two children
  int* done;        // [1] blocks past their scans; 0 between launches
  unsigned long long* times;  // timed instantiation: [L - 1, kTimes]
  int n, big_l, F, B, feat_tile, has_mono, nf, si0, max_depth;
  ltt::Params p;
};

// Chunks of the histogram phase for a child of sc rows: they depend on
// sc and the feature tiles only, never on the grid.
__host__ __device__ inline int max_chunks_of(int F, int feat_tile) {
  const int nft = (F + feat_tile - 1) / feat_tile;
  return kMaxVBlocks / nft > 1 ? kMaxVBlocks / nft : 1;
}

__device__ __forceinline__ int child_chunks(long long sc, int max_chunks) {
  const long long c = (sc + kChunkRows - 1) / kChunkRows;
  return (int)max(1LL, min((long long)max_chunks, c));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The timed instantiation's clock reads, block 0 / thread 0 only: row
// k - 1 of a.times holds %globaltimer in [0, 8) and clock64 in [8, 16)
// at the kernel's entry (slot 0) and after each phase: 1 site, 2 lid
// pass, 3 compaction, 4 histogram, 5 reduce, 6 its scans; slot 7 holds
// the ns after the state is written (stamp_finish); in [16, 20) block
// 0's histogram cycles (first fetch, stores, accumulation, write-out,
// Laps) and in [20, 25) clock64 inside its first scan (scan_feature's
// clk).
template <bool kTimed>
__device__ __forceinline__ void stamp(const Args& a, int k, int slot,
                                      unsigned long long ns,
                                      unsigned long long cyc) {
  if constexpr (kTimed) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.times[(size_t)(k - 1) * kTimes + slot] = ns;
      a.times[(size_t)(k - 1) * kTimes + 8 + slot] = cyc;
    }
  }
}

template <bool kTimed>
__device__ __forceinline__ void stamp(const Args& a, int k, int slot) {
  if constexpr (kTimed) stamp<true>(a, k, slot, global_ns(), clock64());
}

// slot 7: the block that writes the state (any block; ns only)
template <bool kTimed>
__device__ __forceinline__ void stamp_finish(const Args& a, int k) {
  if constexpr (kTimed) a.times[(size_t)(k - 1) * kTimes + 7] = global_ns();
}

// cycles since the last lap into acc (timed build, thread 0's view)
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

__device__ __forceinline__ void load_ids(const int* ids, long long s0, int m,
                                         int (&rid)[kPer]) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = u * kThreads + threadIdx.x;
    rid[u] = j < m ? __ldcg(ids + s0 + j) : -1;
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

// Whole block: the sum of x over the block to every thread (integers,
// so the order does not matter). red: shared int[kWarps].
__device__ __forceinline__ int block_sum(int x, int* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
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

template <typename BinT, int kCap, bool kTimed>
__global__ void __launch_bounds__(kThreads, 2)
split_step_leaf_kernel(Args a) {
  const unsigned long long ns0 = kTimed ? global_ns() : 0;
  const unsigned long long cyc0 = kTimed ? clock64() : 0;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ ltt::Site site;
  __shared__ int iscratch[33];
  __shared__ float fscratch[kWarps];
  __shared__ bool last;
  cg::grid_group grid = cg::this_grid();
  const BinT* bins = static_cast<const BinT*>(a.bins);

  // ---- 0. the split site ---------------------------------------------
  ltt::read_site(a, site, fscratch, iscratch);
  if (!site.go) return;  // every block decides alike: no barrier skipped
  stamp<kTimed>(a, site.k, 0, ns0, cyc0);
  stamp<kTimed>(a, site.k, 1);
  const int F = a.F, B = a.B;
  const int* im = a.imeta + site.feat * ltt::IM_COLS;
  const ltt::Decision d{site.feat, site.thr, site.dleft, im[ltt::IM_MISS],
                        im[ltt::IM_DEFBIN], im[ltt::IM_NBINS], 0, nullptr};
  const ltt::Pair q = ltt::derive_pair(a, site);
  const int leaf = site.leaf, nw = site.k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = a.n;

  // ---- 1. lid pass over this block's rows [r0, r1) -------------------
  // per is a multiple of 32, so a warp's 32 rows are one mask word
  const long long per = ((n + gridDim.x - 1) / gridDim.x + 31) & ~31LL;
  const long long r0 = min(n, (long long)blockIdx.x * per);
  const long long r1 = min(n, r0 + per);
  int members = 0;  // lane 0: this warp's member count
  for (long long base = r0; base < r1;
       base += (long long)kThreads * kLidUnroll) {
    int v[kLidUnroll], bv[kLidUnroll];
#pragma unroll
    for (int u = 0; u < kLidUnroll; ++u) {
      const long long r = base + u * kThreads + threadIdx.x;
      v[u] = r < r1 ? a.lid[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kLidUnroll; ++u) {
      const long long r = base + u * kThreads + threadIdx.x;
      bv[u] = v[u] == leaf ? (int)bins[(size_t)r * F + site.feat] : 0;
    }
#pragma unroll
    for (int u = 0; u < kLidUnroll; ++u) {
      const long long r = base + u * kThreads + threadIdx.x;
      bool member = false;
      if (v[u] == leaf) {
        const bool left = ltt::go_left(bv[u], d);
        if (!left) a.lid[r] = nw;
        member = left == q.small_left;
      }
      const unsigned bal = __ballot_sync(kFull, member);
      const long long w0 = base + u * kThreads + warp * 32;
      if (lane == 0 && w0 < r1) {
        a.mask[w0 >> 5] = bal;
        members += __popc(bal);
      }
    }
  }
  {
    const int total = block_sum(lane == 0 ? members : 0, iscratch);
    if (threadIdx.x == 0) a.counts[blockIdx.x] = total;
  }
  grid.sync();
  stamp<kTimed>(a, site.k, 2);

  // ---- 2. compaction: the child's row ids, in row order --------------
  long long sc;
  {
    int before = 0, all = 0;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
      const int c = __ldcg(a.counts + j);
      all += c;
      before += j < (int)blockIdx.x ? c : 0;
    }
    int run = block_sum(before, iscratch);
    sc = block_sum(all, iscratch);
    // this block's mask words (none when its range is empty: r0 = n
    // need not be a multiple of 32 there)
    const long long wb0 = r0 >> 5, wb1 = r1 > r0 ? (r1 + 31) >> 5 : wb0;
    for (long long w0 = wb0; w0 < wb1; w0 += kThreads) {
      const long long wi = w0 + threadIdx.x;
      const unsigned word = wi < wb1 ? __ldcg(a.mask + wi) : 0u;
      const int x = __popc(word);
      int incl = x;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) iscratch[warp] = incl;
      __syncthreads();
      int wbase = run, tot = 0;
      for (int w = 0; w < kWarps; ++w) {
        wbase += w < warp ? iscratch[w] : 0;
        tot += iscratch[w];
      }
      const int excl = wbase + incl - x;
      // the warp's 32 words, one at a time, each lane one row: coalesced
      for (int j = 0; j < 32; ++j) {
        const unsigned wd = __shfl_sync(kFull, word, j);
        const int e = __shfl_sync(kFull, excl, j);
        if ((wd >> lane) & 1u)
          a.ids[e + __popc(wd & ((1u << lane) - 1u))] =
              (int)((w0 + warp * 32 + j) * 32 + lane);
      }
      run += tot;
      __syncthreads();  // iscratch is reused
    }
  }
  grid.sync();
  stamp<kTimed>(a, site.k, 3);

  // ---- 3. the smaller child's histogram over ids ---------------------
  const int nft = (F + a.feat_tile - 1) / a.feat_tile;
  const int chunks = child_chunks(sc, max_chunks_of(F, a.feat_tile));
  const long long chunk = (sc + chunks - 1) / chunks;
  const bool direct = chunks == 1;
  const int idx_a = q.small_left ? leaf : nw;
  const int idx_b = q.small_left ? nw : leaf;
  const size_t fb3 = (size_t)F * B * 3;
  {
    double* hist_s = reinterpret_cast<double*>(dyn);
    float* g_s =
        reinterpret_cast<float*>(hist_s + (size_t)a.feat_tile * B * 3);
    float* h_s = g_s + kStageRows;
    float* c_s = h_s + kStageRows;
    BinT* bin_s = reinterpret_cast<BinT*>(c_s + kStageRows);
    Laps<kTimed> clk;
    for (int v = blockIdx.x; v < chunks * nft; v += gridDim.x) {
      clk.start();
      const int c = v / nft, f0 = (v % nft) * a.feat_tile;
      const int nf = min(a.feat_tile, F - f0);
      const int n3 = nf * B * 3;
      for (int i = threadIdx.x; i < n3; i += kThreads) hist_s[i] = 0.0;
      const long long i0 = min(sc, (long long)c * chunk);
      const long long i1 = min(sc, i0 + chunk);
      // a two-step pipeline: the rows of step s + 1 load into registers
      // while step s is accumulated, the ids of step s + 2 likewise
      Staged<BinT> st;
      int nid[kPer];
      load_ids(a.ids, i0, (int)min((long long)kStageRows, i1 - i0), st.rid);
      load_rows(a.ghc, bins, F, f0, nf, st);
      load_ids(a.ids, i0 + kStageRows,
               (int)max(0LL, min((long long)kStageRows,
                                 i1 - i0 - kStageRows)),
               nid);
      clk.lap(0);
      for (long long s0 = i0; s0 < i1; s0 += kStageRows) {
        const int m = (int)min((long long)kStageRows, i1 - s0);
        __syncthreads();  // the last step's stage is read (and zeroed)
        clk.lap(2);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int j = u * kThreads + threadIdx.x;
          if (st.rid[u] < 0) continue;
          g_s[j] = st.g[u];
          h_s[j] = st.h[u];
          c_s[j] = st.c[u];
#pragma unroll
          for (int fl = 0; fl < kMaxTile; ++fl)
            if (fl < nf) bin_s[fl * kStageRows + j] = st.bin[u][fl];
        }
        __syncthreads();
        clk.lap(1);
        const long long s1 = s0 + kStageRows;
        if (s1 < i1) {
#pragma unroll
          for (int u = 0; u < kPer; ++u) st.rid[u] = nid[u];
          load_rows(a.ghc, bins, F, f0, nf, st);
          load_ids(a.ids, s1 + kStageRows,
                   (int)max(0LL, min((long long)kStageRows,
                                     i1 - s1 - kStageRows)),
                   nid);
        }
        for (int fl = warp; fl < nf; fl += kWarps) {
          double* hf = hist_s + (size_t)fl * B * 3;
          const BinT* bs = bin_s + fl * kStageRows;
          for (int base = 0; base < m; base += 32 * kGroups)
            add_groups(bs, base, m, lane, g_s, h_s, c_s, hf);
        }
      }
      __syncthreads();
      clk.lap(2);
      const size_t off = (size_t)f0 * B * 3;
      if (direct) {
        // the tile of the whole child: rounded once, into the cache
        for (int i = threadIdx.x; i < n3; i += kThreads) {
          const float child = (float)hist_s[i];
          const float parent = __ldcg(a.hist + leaf * fb3 + off + i);
          a.hist[idx_a * fb3 + off + i] = child;
          a.hist[idx_b * fb3 + off + i] = parent - child;
        }
      } else {
        double* dst = a.partial + c * fb3 + off;
        for (int i = threadIdx.x; i < n3; i += kThreads) dst[i] = hist_s[i];
      }
      __syncthreads();  // hist_s is zeroed by the next virtual block
      clk.lap(3);
    }
    if constexpr (kTimed) {
      if (blockIdx.x == 0 && threadIdx.x == 0)
        for (int i = 0; i < 4; ++i)
          a.times[(size_t)(site.k - 1) * kTimes + 16 + i] = clk.acc[i];
    }
  }
  grid.sync();
  stamp<kTimed>(a, site.k, 4);

  // ---- 4. child = partials in chunk order, rounded once; sibling ------
  if (!direct) {
    const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long gsize = (long long)gridDim.x * blockDim.x;
    for (long long i = gtid; i < (long long)fb3; i += gsize) {
      // in chunk order, four partials' loads in flight at a time
      const double* pi = a.partial + i;
      double s = __ldcg(pi);
      int c = 1;
      for (; c + 3 < chunks; c += 4) {
        const double p0 = __ldcg(pi + c * fb3);
        const double p1 = __ldcg(pi + (c + 1) * fb3);
        const double p2 = __ldcg(pi + (c + 2) * fb3);
        const double p3 = __ldcg(pi + (c + 3) * fb3);
        s += p0;
        s += p1;
        s += p2;
        s += p3;
      }
      for (; c < chunks; ++c) s += __ldcg(pi + c * fb3);
      const float child = (float)s;
      const float parent = __ldcg(a.hist + leaf * fb3 + i);
      a.hist[idx_a * fb3 + i] = child;
      a.hist[idx_b * fb3 + i] = parent - child;
    }
    grid.sync();
  }
  stamp<kTimed>(a, site.k, 5);

  // ---- 5. both children's scans (the planes reuse the histogram's
  // shared memory, free after the sync above) --------------------------
  auto& scan_sm = *reinterpret_cast<ltt::ScanSmem<kCap>*>(dyn);
  for (int v = blockIdx.x; v < 2 * F; v += gridDim.x) {
    const int c = v / F, f = v % F;
    const float* h =
        a.hist + ((c == 0 ? idx_a : idx_b) * (size_t)F + f) * B * 3;
    const int* mf = a.imeta + f * ltt::IM_COLS;
    ltt::scan_feature<kCap, kTimed>(
        h, B, c == 0 ? q.a : q.b, mf[ltt::IM_NBINS], mf[ltt::IM_MISS],
        mf[ltt::IM_DEFBIN], mf[ltt::IM_MONO], a.fmeta[f * 2 + 0],
        a.fmeta[f * 2 + 1], a.p, scan_sm, a.table + ((size_t)c * F + f) * 8,
        kTimed && v == 0 ? a.times + (size_t)(site.k - 1) * kTimes + 20
                         : nullptr);
  }
  stamp<kTimed>(a, site.k, 6);

  // ---- 6. state, tree arrays, k: the last block past its scans -------
  // thread 0 wrote this block's table rows (scan_feature); the fence
  // makes them visible before the count that lets the last block read
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.done, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) *a.done = 0;
  ltt::finish_block(a, site, q, 0, 0, 0, 0, iscratch);
  if (threadIdx.x == 0) stamp_finish<kTimed>(a, site.k);
}

// dynamic shared memory: the histogram tile (float64) and the staged
// rows, or the scan planes, whichever is larger
size_t leaf_smem_bytes(int bin_bytes, int B, int feat_tile,
                       size_t scan_bytes) {
  const size_t hist = (size_t)feat_tile * B * 3 * sizeof(double) +
                      (size_t)kStageRows * 3 * sizeof(float) +
                      (size_t)feat_tile * kStageRows * bin_bytes;
  return hist > scan_bytes ? hist : scan_bytes;
}

// Launch shape of one instance: blocks per SM and grid, cached per
// (device, shared-memory size).
template <typename BinT, int kCap, bool kTimed>
int leaf_grid(size_t smem, int* per_sm_out, int* grid_out) {
  static int dev_c = -1, per_sm_c = 0, grid_c = 0;
  static size_t smem_c = 0;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_c || smem != smem_c) {
    const int err = ltt::cooperative_grid(
        split_step_leaf_kernel<BinT, kCap, kTimed>, kThreads, smem,
        &per_sm_c, &grid_c);
    if (err) return err;
    dev_c = dev;
    smem_c = smem;
  }
  *per_sm_out = per_sm_c;
  *grid_out = grid_c;
  return 0;
}

// grid, shared memory and the chunk cap of one launch
template <bool kTimed>
int leaf_shape(int bin_bytes, int n, int F, int B, int feat_tile,
               int* out) {
  if (B < 1 || F < 1 || feat_tile < 1 || feat_tile > kMaxTile || n < 1 ||
      (bin_bytes == 1 && B > ltt::kMaxBins) ||
      (bin_bytes == 2 && B > ltt::kMaxScanBins) ||
      (bin_bytes != 1 && bin_bytes != 2))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  int err;
  if (bin_bytes == 1) {
    smem = leaf_smem_bytes(1, B, feat_tile,
                           sizeof(ltt::ScanSmem<ltt::kMaxBins>));
    err = leaf_grid<uint8_t, ltt::kMaxBins, kTimed>(smem, &out[0], &out[1]);
  } else {
    smem = leaf_smem_bytes(2, B, feat_tile,
                           sizeof(ltt::ScanSmem<ltt::kMaxScanBins>));
    err = leaf_grid<uint16_t, ltt::kMaxScanBins, kTimed>(smem, &out[0],
                                                         &out[1]);
  }
  out[2] = (int)smem;
  out[3] = max_chunks_of(F, feat_tile);
  return err;
}

template <bool kTimed>
int launch_leaf(int bin_bytes, int* k, float* S, float* T, int* lid,
                float* hist, const void* bins, const float* ghc,
                const int* imeta, const float* fmeta, double* partial,
                unsigned* mask, int* ids, int* counts, float* table,
                int* done, unsigned long long* times, int n, int big_l,
                int F, int B,
                int feat_tile, int grid_cap, int has_mono, int max_depth,
                ltt::Params p, cudaStream_t stream) {
  int shape[4];
  const int err = leaf_shape<kTimed>(bin_bytes, n, F, B, feat_tile, shape);
  if (err) return err;
  // counts holds grid_cap ints, one per block
  if (big_l < 2 || shape[1] > grid_cap) return (int)cudaErrorInvalidValue;
  Args a{k,     S,     T,       lid,   hist,  bins,      ghc,
         imeta, fmeta, partial, mask,  ids,   counts,    table,
         done,  times, n,       big_l, F,     B,         feat_tile,
         has_mono, has_mono ? 12 : 10, 0, max_depth, p};
  void* params[] = {&a};
  const void* fn =
      bin_bytes == 1
          ? (const void*)split_step_leaf_kernel<uint8_t, ltt::kMaxBins,
                                                kTimed>
          : (const void*)split_step_leaf_kernel<uint16_t, ltt::kMaxScanBins,
                                                kTimed>;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(shape[1]), dim3(kThreads), params, (size_t)shape[2], stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape of the leaf step: out[0] blocks per SM, out[1] grid
// size, out[2] dynamic shared-memory bytes per block, out[3] the most
// histogram chunks of one split (the leading dimension of the
// partials).
LTT_EXPORT int ltt_split_step_leaf_shape(int bin_bytes, int n, int F, int B,
                                         int feat_tile, int* out) {
  return leaf_shape<false>(bin_bytes, n, F, B, feat_tile, out);
}

// k: device int32[1]; S [nf + 7, L], T [9, L - 1] f32; lid int32[n];
// hist [L, F, B, 3] f32; bins [n, F] u8 (bin_bytes 1) or u16 (2); ghc
// [n, 3] f32; imeta [F, 8] i32, fmeta [F, 2] f32; partial
// [max_chunks, F, B, 3] f64, mask u32[ceil(n / 32)], ids int32[n],
// counts int32[grid_cap] (grid_cap >= the grid), table [2, F, 8] f32,
// done int32[1] (0 before the first launch; each launch leaves it 0).
LTT_EXPORT int ltt_split_step_leaf(
    int bin_bytes, int* k, float* S, float* T, int* lid, float* hist,
    const void* bins, const float* ghc, const int* imeta, const float* fmeta,
    double* partial, unsigned* mask, int* ids, int* counts, float* table,
    int* done, int n, int big_l, int F, int B, int feat_tile, int grid_cap,
    int has_mono, int max_depth, float l1, float l2, float mds,
    float min_data, float min_hess, float min_gain, cudaStream_t stream) {
  return launch_leaf<false>(
      bin_bytes, k, S, T, lid, hist, bins, ghc, imeta, fmeta, partial, mask,
      ids, counts, table, done, nullptr, n, big_l, F, B, feat_tile, grid_cap,
      has_mono, max_depth,
      ltt::Params{l1, l2, mds, min_data, min_hess, min_gain}, stream);
}

// The timed instantiation (chip_profile.py only): the same split, and
// block 0 writes its clock reads of split k into row k - 1 of times
// (u64 [L - 1, 32]; see stamp).
LTT_EXPORT int ltt_split_step_leaf_timed(
    int bin_bytes, int* k, float* S, float* T, int* lid, float* hist,
    const void* bins, const float* ghc, const int* imeta, const float* fmeta,
    double* partial, unsigned* mask, int* ids, int* counts, float* table,
    int* done, int n, int big_l, int F, int B, int feat_tile, int grid_cap,
    int has_mono, int max_depth, float l1, float l2, float mds,
    float min_data, float min_hess, float min_gain,
    unsigned long long* times, cudaStream_t stream) {
  return launch_leaf<true>(
      bin_bytes, k, S, T, lid, hist, bins, ghc, imeta, fmeta, partial, mask,
      ids, counts, table, done, times, n, big_l, F, B, feat_tile, grid_cap,
      has_mono, max_depth,
      ltt::Params{l1, l2, mds, min_data, min_hess, min_gain}, stream);
}
