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
//  3. the histogram over ids, the row loop of hist_ids.cuh (shared with
//     hist_rows.cu, so a per-phase child's histogram is this one bit for
//     bit): (chunk, feature tile) virtual blocks, the chunks cut from sc
//     alone (kChunkRows rows each, at most kMaxVBlocks / tiles of them),
//     so the summation order does not depend on the card. A virtual
//     block stages kStageRows rows' ghc and tile bins in shared memory
//     through the id list (independent loads in flight), then warp w
//     owns features w, w + 8, ... of the tile; in each 32-row group the
//     lanes of one bin find each other through an integer peer word a
//     bin, and the lowest adds its peers in lane order (hist_ids.cuh).
//     Sums are float64 in shared memory, so a bin's sum depends on the
//     row order alone; counts are integers. A child of one chunk
//     (sc <= kChunkRows) writes its rounded child row and parent - child
//     straight into the cache; otherwise each chunk writes a float64
//     partial | sync;
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
//
// The model-batched step (ltt_split_step_leaf_batched, the multiboost
// learner's: the JAX package vmaps this kernel along a model axis) does
// split k of each of M models over one shared bin matrix in one
// cooperative launch, with this kernel's grid syncs. It runs this
// kernel's histogram and scan functions (hist_vblock, scan_vblock) on
// each model's own state, and its lid pass, compaction and reduce for
// all the models at once with the same writes (lid_group,
// compact_group, reduce_elem), so each model's split is this kernel's
// bit for bit; see the note above split_step_leaf_batched_kernel.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "hist_ids.cuh"
#include "partition_core.cuh"
#include "scan_core.cuh"
#include "split_state.cuh"

namespace cg = cooperative_groups;

namespace {

using ltt::ids::kThreads;
using ltt::ids::kWarps;
using ltt::ids::kMaxTile;
using ltt::ids::kFull;
using ltt::ids::Laps;
constexpr int kLidUnroll = 16;     // rows a thread keeps in flight (lid pass)
constexpr int kTimes = 32;         // clock reads per split (timed build)
constexpr int kTreeRows = 9;       // rows of T (split_state.cuh T_*)
// the histogram's leaders read their own lanes' (g, h) and count bits
// from the stage (hist_ids.cuh add_groups, kOwn false): held in
// registers, as hist_rows.cu holds them, they cost this kernel spills
// and its other phases time (chip_profile.py --leaf-phases)
constexpr bool kLeafOwn = false;

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

// ---- the phases of a split, shared by the single-model kernel and the
// model-batched one (each model's split is the single kernel's, bit for
// bit, because both run these same functions on the model's own state)

// Phase 1, one block: the lid pass over rows [r0, r1) of one model. A
// row of `leaf` decides its side from the split feature's bin,
// right-going rows get lid = nw, a warp ballot writes the smaller
// child's membership bits (r0 and the range's length multiples of 32, so
// a warp's 32 rows are one mask word). Returns the block's member count
// to every thread.
template <typename BinT>
__device__ __forceinline__ int lid_pass(int* lid, unsigned* mask,
                                        const BinT* bins, int F,
                                        const ltt::Decision& d, int leaf,
                                        int nw, bool small_left,
                                        long long r0, long long r1,
                                        int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int members = 0;  // lane 0: this warp's member count
  for (long long base = r0; base < r1;
       base += (long long)kThreads * kLidUnroll) {
    int v[kLidUnroll], bv[kLidUnroll];
#pragma unroll
    for (int u = 0; u < kLidUnroll; ++u) {
      const long long r = base + u * kThreads + threadIdx.x;
      v[u] = r < r1 ? lid[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kLidUnroll; ++u) {
      const long long r = base + u * kThreads + threadIdx.x;
      bv[u] = v[u] == leaf ? (int)bins[(size_t)r * F + d.feat] : 0;
    }
#pragma unroll
    for (int u = 0; u < kLidUnroll; ++u) {
      const long long r = base + u * kThreads + threadIdx.x;
      bool member = false;
      if (v[u] == leaf) {
        const bool left = ltt::go_left(bv[u], d);
        if (!left) lid[r] = nw;
        member = left == small_left;
      }
      const unsigned bal = __ballot_sync(kFull, member);
      const long long w0 = base + u * kThreads + warp * 32;
      if (lane == 0 && w0 < r1) {
        mask[w0 >> 5] = bal;
        members += __popc(bal);
      }
    }
  }
  return block_sum(lane == 0 ? members : 0, red);
}

// Phase 2, one block: the members of rows [r0, r1) (the j-th of nblocks
// ranges, whose member counts are counts[0, nblocks)) to ids, in row
// order, from the range's mask words. Returns the child's row count.
__device__ __forceinline__ long long compact_ids(const int* counts,
                                                 int nblocks, int j,
                                                 const unsigned* mask,
                                                 int* ids, long long r0,
                                                 long long r1, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) {
    const int c = __ldcg(counts + i);
    all += c;
    before += i < j ? c : 0;
  }
  int run = block_sum(before, red);
  const long long sc = block_sum(all, red);
  // this range's mask words (none when it is empty: r0 = n need not be
  // a multiple of 32 there)
  const long long wb0 = r0 >> 5, wb1 = r1 > r0 ? (r1 + 31) >> 5 : wb0;
  for (long long w0 = wb0; w0 < wb1; w0 += kThreads) {
    const long long wi = w0 + threadIdx.x;
    const unsigned word = wi < wb1 ? __ldcg(mask + wi) : 0u;
    const int x = __popc(word);
    int incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) red[warp] = incl;
    __syncthreads();
    int wbase = run, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      wbase += w < warp ? red[w] : 0;
      tot += red[w];
    }
    const int excl = wbase + incl - x;
    // the warp's 32 words, one at a time, each lane one row: coalesced
    for (int i = 0; i < 32; ++i) {
      const unsigned wd = __shfl_sync(kFull, word, i);
      const int e = __shfl_sync(kFull, excl, i);
      if ((wd >> lane) & 1u)
        ids[e + __popc(wd & ((1u << lane) - 1u))] =
            (int)((w0 + warp * 32 + i) * 32 + lane);
    }
    run += tot;
    __syncthreads();  // red is reused
  }
  return sc;
}

// Phase 3, one block: virtual block (chunk c, feature tile t) of one
// model's smaller child of sc rows ids[0, sc), cut into chunks of
// `chunk` rows (hist_ids.cuh). A child of one chunk (`direct`) writes
// its tile, rounded once, and the sibling (parent row `leaf` - child)
// straight into the cache rows idx_a, idx_b; otherwise the chunk writes
// its float64 partial. The caller computes chunk, direct and fb3 (F B 3):
// the single kernel once a split, outside its loop over virtual blocks.
template <typename BinT, bool kTimed, bool kOwn = kLeafOwn>
__device__ __forceinline__ void hist_vblock(
    const int* ids, long long sc, long long chunk, bool direct, int c,
    int t, const float* ghc, const BinT* bins, int F, int B, int feat_tile,
    size_t fb3, float* hist, int leaf, int idx_a, int idx_b,
    double* partial, const ltt::ids::TileSmem<BinT>& tile,
    Laps<kTimed>& clk) {
  const int f0 = t * feat_tile;
  const int nf = min(feat_tile, F - f0);
  const int n3 = nf * B * 3;
  const long long i0 = min(sc, (long long)c * chunk);
  const long long i1 = min(sc, i0 + chunk);
  ltt::ids::hist_chunk<BinT, true, kTimed, kOwn>(ids, i0, i1, ghc, bins, F,
                                                 f0, nf, B, tile, clk);
  const size_t off = (size_t)f0 * B * 3;
  if (direct) {
    // the tile of the whole child: rounded once, into the cache
    for (int i = threadIdx.x; i < n3; i += kThreads) {
      const float child = (float)ltt::ids::tile_value(tile, i);
      const float parent = __ldcg(hist + leaf * fb3 + off + i);
      hist[idx_a * fb3 + off + i] = child;
      hist[idx_b * fb3 + off + i] = parent - child;
    }
  } else {
    double* dst = partial + c * fb3 + off;
    for (int i = threadIdx.x; i < n3; i += kThreads)
      dst[i] = ltt::ids::tile_value(tile, i);
  }
  __syncthreads();  // the tile is zeroed by the next virtual block
}

// Phase 4, elements [gtid, fb3) in steps of gsize: one model's child as
// its partials summed in chunk order, rounded once; sibling = parent -
// child in float32; both cache rows written.
__device__ __forceinline__ void reduce_child(const double* partial,
                                             int chunks, size_t fb3,
                                             float* hist, int leaf,
                                             int idx_a, int idx_b,
                                             long long gtid,
                                             long long gsize) {
  for (long long i = gtid; i < (long long)fb3; i += gsize) {
    // in chunk order, four partials' loads in flight at a time
    const double* pi = partial + i;
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
    const float parent = __ldcg(hist + leaf * fb3 + i);
    hist[idx_a * fb3 + i] = child;
    hist[idx_b * fb3 + i] = parent - child;
  }
}

// Phase 5, one block: the scan of feature f of child c (0: the smaller,
// cache row idx_a; 1: the other, idx_b) under params p into its table
// row (table: the model's [2, F, 8]).
template <int kCap, bool kTimed>
__device__ __forceinline__ void scan_vblock(const float* hist, int F, int B,
                                            int c, int f, int idx_a,
                                            int idx_b, const ltt::Pair& q,
                                            const int* imeta,
                                            const float* fmeta,
                                            const ltt::Params& p,
                                            ltt::ScanSmem<kCap>& sm,
                                            float* table,
                                            unsigned long long* clk) {
  const float* h = hist + ((c == 0 ? idx_a : idx_b) * (size_t)F + f) * B * 3;
  const int* mf = imeta + f * ltt::IM_COLS;
  // the running sums held in registers (kHold): measured faster here
  // than adding them again
  ltt::scan_feature<kCap, kTimed, true>(
      h, B, c == 0 ? q.a : q.b, mf[ltt::IM_NBINS], mf[ltt::IM_MISS],
      mf[ltt::IM_DEFBIN], mf[ltt::IM_MONO], fmeta[f * 2 + 0],
      fmeta[f * 2 + 1], p, sm, table + ((size_t)c * F + f) * 8, clk);
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
  const long long n = a.n;

  // ---- 1. lid pass over this block's rows [r0, r1) -------------------
  // per is a multiple of 32, so a warp's 32 rows are one mask word
  const long long per = ((n + gridDim.x - 1) / gridDim.x + 31) & ~31LL;
  const long long r0 = min(n, (long long)blockIdx.x * per);
  const long long r1 = min(n, r0 + per);
  {
    const int total = lid_pass(a.lid, a.mask, bins, F, d, leaf, nw,
                               q.small_left, r0, r1, iscratch);
    if (threadIdx.x == 0) a.counts[blockIdx.x] = total;
  }
  grid.sync();
  stamp<kTimed>(a, site.k, 2);

  // ---- 2. compaction: the child's row ids, in row order --------------
  const long long sc = compact_ids(a.counts, gridDim.x, blockIdx.x, a.mask,
                                   a.ids, r0, r1, iscratch);
  grid.sync();
  stamp<kTimed>(a, site.k, 3);

  // ---- 3. the smaller child's histogram over ids (hist_ids.cuh) ------
  const int nft = ltt::ids::feature_tiles(F, a.feat_tile);
  const int chunks = ltt::ids::child_chunks(
      sc, ltt::ids::max_chunks_of(F, a.feat_tile));
  const long long chunk = (sc + chunks - 1) / chunks;
  const bool direct = chunks == 1;
  const int idx_a = q.small_left ? leaf : nw;
  const int idx_b = q.small_left ? nw : leaf;
  const size_t fb3 = (size_t)F * B * 3;
  {
    const ltt::ids::TileSmem<BinT> tile =
        ltt::ids::carve<BinT>(dyn, a.feat_tile, B);
    Laps<kTimed> clk;
    for (int v = blockIdx.x; v < chunks * nft; v += gridDim.x) {
      clk.start();
      hist_vblock<BinT, kTimed>(a.ids, sc, chunk, direct, v / nft, v % nft,
                                a.ghc, bins, F, B, a.feat_tile, fb3, a.hist,
                                leaf, idx_a, idx_b, a.partial, tile, clk);
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
    reduce_child(a.partial, chunks, fb3, a.hist, leaf, idx_a, idx_b,
                 (long long)blockIdx.x * blockDim.x + threadIdx.x,
                 (long long)gridDim.x * blockDim.x);
    grid.sync();
  }
  stamp<kTimed>(a, site.k, 5);

  // ---- 5. both children's scans (the planes reuse the histogram's
  // shared memory, free after the sync above) --------------------------
  auto& scan_sm = *reinterpret_cast<ltt::ScanSmem<kCap>*>(dyn);
  for (int v = blockIdx.x; v < 2 * F; v += gridDim.x)
    scan_vblock<kCap, kTimed>(
        a.hist, F, B, v / F, v % F, idx_a, idx_b, q, a.imeta, a.fmeta, a.p,
        scan_sm, a.table,
        kTimed && v == 0 ? a.times + (size_t)(site.k - 1) * kTimes + 20
                         : nullptr);
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

// ---- the model-batched step -----------------------------------------
// One launch does split k[m] of every model m of a bucket, over one
// shared bin matrix, each model with its own state, gradients and
// Params, each model's split this kernel's bit for bit.
//
// What bounds it on the H100: as the single step, bytes -- every
// model's lid pass reads its lid[N] (8 MB a model at 2M rows) and the
// bins of its leaf's rows; every model's smaller child is read for its
// histogram, whose chunks (the chunk rule's, which fixes every sum's
// order) each write a float64 partial of the whole tile that the reduce
// reads back -- plus, at B models, the per-model work the single kernel
// has once: B sites, B walks of a block's rows, B block reductions, B
// reduces. The timed build (chip_profile.py --batched-phases) put a B 4
// tree's average launch at 28% lid pass, 31% histogram, 18% reduce
// (model after model) and 7% compaction before this design; after it,
// 24% lid pass (its walk waits on the lid words and the leaf rows'
// bins), 38% histogram (each model's own child, the single kernel's
// loop), 12% reduce (near the partials' bytes) and 9% compaction.
//
// Design: one cooperative launch; the phases of the single kernel with
// its grid syncs (three, four with a reduce), each shared by the whole
// bucket:
//  0. every block reads every model's site itself (warp w the models
//     w, w + 8, ...: read_site_warp, read_site's argmax and column) and
//     keeps it, the lid pass's cut and later the child's row count in
//     shared memory (MState) for the whole launch: no block reads S
//     again (a model's last scan block rewrites its S while others
//     still run), and no grid sync publishes the sites;
//  1. the lid pass over the block's rows [r0, r1) (the single kernel's
//     ranges), one walk for up to kGroupModels going models
//     (lid_group): each thread keeps kGroupSlots (row, model) lid words
//     in flight and the next step's while a step is decided, a row's
//     bins are read for all the models' split features together, a
//     32-row group with no row in a model's leaf skips its decision, a
//     warp stores its mask words in one instruction, and one block
//     reduction gives all the member counts | sync;
//  2. the compaction (compact_group): one block reduction for every
//     model's offset and child row count sc (every block computes the
//     same), then one walk of the range's mask words, every model's
//     words of a step loaded together and one block reduction a step for
//     all | sync;
//  3. the histograms: (model, chunk, feature tile) virtual blocks of
//     hist_vblock, each model's chunks from its own sc, the leaders'
//     own (g, h) from registers (kBatchedOwn) | sync;
//  4. the reduce of the children of more than one chunk, over (model,
//     element) at once, eight partials' loads in flight (reduce_elem;
//     the adds in chunk order, as reduce_child) | sync;
//  5. the scans: (model, child, feature) virtual blocks; the last of a
//     model's 2F scans to count itself (a done counter a model) writes
//     that model's state (finish_block).
// A model whose grow condition fails has no virtual block and its state
// is left as it was; the same lid values, mask words, counts, row ids,
// partials, cache rows and tables as the single kernel's, so the same
// bits.

struct BArgs {
  int* k;               // [M]
  float* S;             // [M, Ks, L]
  float* T;             // [M, 9, L - 1]
  int* lid;             // [M, N]
  float* hist;          // [M, L, F, B, 3]
  const void* bins;     // [N, F], shared
  const float* ghc;     // [M, N, 3]
  const int* imeta;     // shared
  const float* fmeta;   // shared
  const float* params;  // [M, 6]: l1, l2, mds, min_data, min_hess, min_gain
  double* partial;      // [M, max_chunks, F, B, 3]
  unsigned* mask;       // [M, ceil(N / 32)]
  int* ids;             // [M, N]
  int* counts;          // [M, grid]
  float* table;         // [M, 2, F, 8]
  int* done;            // [M]
  unsigned long long* times;  // timed instantiation: this launch's [kTimes]
  int models, n, big_l, F, B, feat_tile, max_chunks, has_mono, nf,
      max_depth, state_off;
};

// model m's view: the fields split_state.cuh reads
struct MArgs {
  int* k;
  float* S;
  float* T;
  const int* imeta;
  float* table;
  int big_l, F, has_mono, nf, si0, max_depth;
  ltt::Params p;
};

__device__ __forceinline__ MArgs model_args(const BArgs& a, int m) {
  const size_t ks = (size_t)(a.nf + ltt::SI_ROWS) * a.big_l;
  const size_t kt = (size_t)kTreeRows * (a.big_l - 1);
  const float* pm = a.params + (size_t)m * 6;
  return MArgs{a.k + m,
               a.S + m * ks,
               a.T + m * kt,
               a.imeta,
               a.table + (size_t)m * 2 * a.F * 8,
               a.big_l,
               a.F,
               a.has_mono,
               a.nf,
               0,
               a.max_depth,
               ltt::Params{pm[0], pm[1], pm[2], pm[3], pm[4], pm[5]}};
}

// The lid pass's decision of a model's split (from its site and the
// split feature's metadata).
struct Cut {
  int leaf, nw, small_left, feat, thr, dleft, miss, defbin, nbins;
};

// A model's split as every block keeps it in shared memory from phase 0
// on: its site, its cut, its smaller child's row count (phase 2).
struct MState {
  long long sc;
  ltt::Site s;
  Cut cut;
};

// shared bytes a model past the histogram's or the scans' (an MState
// and its entry in the list of going models); the Python mirror is
// ops/split_step_cuda.py LEAF_BATCHED_MODEL_BYTES
constexpr int kModelSmem = 144;
static_assert(sizeof(MState) + sizeof(int) <= kModelSmem, "a model's state");
// going models a walk of the lid pass or the compaction takes at once
constexpr int kGroupModels = 8;
// (row, model) lid words a thread of the batched lid pass keeps in
// flight, and as many for the next step (at 32 the kernel spills and
// the walk is slower)
constexpr int kGroupSlots = 16;
// the batched kernel's histogram leaders take their own lanes' (g, h)
// and count bits from registers (add_groups kOwn, hist_rows.cu's loop;
// the same sums as kLeafOwn's)
constexpr bool kBatchedOwn = true;
// the compaction's staging: each thread's mask word and first offset, a
// model of a group
constexpr size_t kCompactBytes = 2 * kGroupModels * kThreads * sizeof(int);

// One warp: model a's split site into s (shared; lane 0 writes), as
// read_site reads it: the argmax under takes of the open leaves'
// bs_gain (a NaN never taken, ties to the first index, so the same
// leaf whatever order the lanes visit them in), the grow condition and
// the leaf's column.
template <class A>
__device__ void read_site_warp(const A& a, ltt::Site& s) {
  const int lane = threadIdx.x & 31;
  const int L = a.big_l;
  const int k = *a.k;
  const int kk = min(k, L);
  const float* gain = a.S + (size_t)ltt::S_BS_GAIN * L;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = lane; j < kk; j += 32)
    if (ltt::takes(gain[j], j, best, bi)) {
      best = gain[j];
      bi = j;
    }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, best, o);
    const int i2 = __shfl_xor_sync(kFull, bi, o);
    if (ltt::takes(v2, i2, best, bi)) {
      best = v2;
      bi = i2;
    }
  }
  if (lane == 0) {
    s.k = k;
    s.leaf = bi;
    s.go = k < L && best > 0.f;
    if (s.go) {
      s.g = ltt::s_at(a, ltt::S_LEAF_G, bi);
      s.h = ltt::s_at(a, ltt::S_LEAF_H, bi);
      s.c = ltt::s_at(a, ltt::S_LEAF_C, bi);
      s.gain = ltt::s_at(a, ltt::S_BS_GAIN, bi);
      s.lg = ltt::s_at(a, ltt::S_BS_LG, bi);
      s.lh = ltt::s_at(a, ltt::S_BS_LH, bi);
      s.lc = ltt::s_at(a, ltt::S_BS_LC, bi);
      s.lout = ltt::s_at(a, ltt::S_BS_LOUT, bi);
      s.rout = ltt::s_at(a, ltt::S_BS_ROUT, bi);
      s.cmin = a.has_mono ? ltt::s_at(a, ltt::S_CMIN, bi) : -INFINITY;
      s.cmax = a.has_mono ? ltt::s_at(a, ltt::S_CMAX, bi) : INFINITY;
      s.begin = 0;
      s.cnt = 0;
      s.feat = ltt::s_int(a, ltt::SI_FEAT, bi);
      s.thr = ltt::s_int(a, ltt::SI_THR, bi);
      s.dleft = ltt::s_int(a, ltt::SI_DLEFT, bi);
      s.ref_node = ltt::s_int(a, ltt::SI_REF_NODE, bi);
      s.ref_side = ltt::s_int(a, ltt::SI_REF_SIDE, bi);
      s.depth = ltt::s_int(a, ltt::SI_DEPTH, bi);
    }
  }
}

// Block 0 / thread 0 of the timed instantiation: clock64 into
// a.times[slot] (the batched kernel's reads inside a phase, slots 20-23)
template <bool kTimed>
__device__ __forceinline__ void bclock(const BArgs& a, int slot) {
  if constexpr (kTimed) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.times[slot] = clock64();
  }
}

// The lid words of rows base + u kThreads + threadIdx.x (u < kU) of
// each of the ng (<= kG) models act[0, ng), -1 past r1 or past ng.
template <int kG, int kU>
__device__ __forceinline__ void load_lids(const int* lid, long long n,
                                          const int* act, int ng,
                                          long long base, long long r1,
                                          int (&v)[kG][kU]) {
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int* lg = lid + (size_t)act[g < ng ? g : 0] * n;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = (int)base + u * kThreads + (int)threadIdx.x;
      v[g][u] = g < ng && r < r1 ? lg[r] : -1;
    }
  }
}

// Phase 1, one block, for the ng (<= kG) going models act[0, ng): each
// model's lid_pass over rows [r0, r1) (the same lid values, mask words
// and member count) in one walk of the rows: kGroupSlots / kG rows a
// thread with every model's lid word of each in flight together, a
// row's bins read for all the models' split features together (one
// sector), the next step's lid words in flight while a step is decided,
// one ballot a (row group, model) into the model's mask words, and one
// block reduction for the ng member counts, written to
// counts[m][blockIdx.x]. red: shared int[kWarps * kG].
template <typename BinT, int kG, bool kTimed>
__device__ __forceinline__ void lid_group(const BArgs& a, const BinT* bins,
                                          const MState* ms, const int* act,
                                          int ng, long long r0, long long r1,
                                          int* red) {
  constexpr int kU = kGroupSlots / kG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = a.n;
  const size_t words = (size_t)((n + 31) >> 5);
  const int F = a.F;
  int members[kG];  // this warp's member count of each model
#pragma unroll
  for (int g = 0; g < kG; ++g) members[g] = 0;
  const long long step = (long long)kThreads * kU;
  // v: a slot's lid word, then (once the bins are asked for) its row's
  // split-feature bin when the row is in the model's leaf, else -1; the
  // next step's lid words load while this step is decided
  int v[kG][kU];
  load_lids<kG, kU>(a.lid, n, act, ng, r0, r1, v);
  for (long long base = r0; base < r1; base += step) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const Cut& c = ms[act[g < ng ? g : 0]].cut;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = (int)base + u * kThreads + (int)threadIdx.x;
        v[g][u] = v[g][u] == c.leaf ? (int)bins[(size_t)r * F + c.feat] : -1;
      }
    }
    int nv[kG][kU];
    load_lids<kG, kU>(a.lid, n, act, ng, base + step, r1, nv);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int m = act[g < ng ? g : 0];
      const Cut& c = ms[m].cut;
      int* lid = a.lid + (size_t)m * n;
      unsigned bal[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = (int)base + u * kThreads + (int)threadIdx.x;
        const int b = v[g][u];
        bal[u] = 0u;
        // a 32-row group with no row in the leaf (most of them, deep in
        // a tree) decides nothing: its ballot is 0
        if (__any_sync(kFull, b >= 0)) {
          // go_left's numerical decision, missing codes included
          const bool missing =
              (c.miss == LTT_MISSING_ZERO && b == c.defbin) ||
              (c.miss == LTT_MISSING_NAN && b == c.nbins - 1);
          const bool left = missing ? c.dleft != 0 : b <= c.thr;
          if (b >= 0 && !left) lid[r] = c.nw;
          bal[u] = __ballot_sync(kFull,
                                 b >= 0 && left == (c.small_left != 0));
        }
      }
      // the warp's kU mask words, lane u storing word u
      unsigned word = 0u;
      int total = 0;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        word = lane == u ? bal[u] : word;
        total += __popc(bal[u]);
      }
      const int w0 = (int)base + lane * kThreads + warp * 32;
      if (g < ng && lane < kU && w0 < r1)
        a.mask[(size_t)m * words + (w0 >> 5)] = word;
      members[g] += total;
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int u = 0; u < kU; ++u) v[g][u] = nv[g][u];
    }
  }
  bclock<kTimed>(a, 20);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) red[warp * kG + g] = members[g];
  }
  __syncthreads();
  if ((int)threadIdx.x < ng) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += red[w * kG + threadIdx.x];
    a.counts[(size_t)act[threadIdx.x] * gridDim.x + blockIdx.x] = s;
  }
  __syncthreads();  // red is reused
  bclock<kTimed>(a, 21);
}

// Phase 2, one block, for the same ng going models: each model's
// compact_ids (its members of rows [r0, r1) to its ids, in row order,
// at its offset from the per-block counts). One block reduction gives
// every model's offset and child row count (to ms[m].sc: every block
// computes the same); then a walk of the range's mask words: every
// model's words of a step load together, their warp scans and one block
// reduction serve all, and each model's rows are written as compact_ids
// writes them. red: shared int[kWarps * 2 kG]; buf: shared int[2 kG
// kThreads] (each thread's words and offsets, by model).
template <int kG, bool kTimed>
__device__ __forceinline__ void compact_group(const BArgs& a, MState* ms,
                                              const int* act, int ng,
                                              long long r0, long long r1,
                                              int* red, int* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblocks = gridDim.x, j = blockIdx.x;
  const long long n = a.n;
  const size_t words = (size_t)((n + 31) >> 5);
  int run[kG], all[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) run[g] = all[g] = 0;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < ng) {
        const int c = __ldcg(a.counts + (size_t)act[g] * nblocks + i);
        all[g] += c;
        run[g] += i < j ? c : 0;
      }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g)
    for (int o = 16; o > 0; o >>= 1) {
      run[g] += __shfl_xor_sync(kFull, run[g], o);
      all[g] += __shfl_xor_sync(kFull, all[g], o);
    }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      red[warp * 2 * kG + g] = run[g];
      red[warp * 2 * kG + kG + g] = all[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    run[g] = all[g] = 0;
    for (int w = 0; w < kWarps; ++w) {
      run[g] += red[w * 2 * kG + g];
      all[g] += red[w * 2 * kG + kG + g];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < ng) ms[act[g]].sc = all[g];
  }
  __syncthreads();  // red is reused
  bclock<kTimed>(a, 22);
  // this range's mask words (none when it is empty: r0 = n need not be
  // a multiple of 32 there)
  const long long wb0 = r0 >> 5, wb1 = r1 > r0 ? (r1 + 31) >> 5 : wb0;
  for (long long w0 = wb0; w0 < wb1; w0 += kThreads) {
    const long long wi = w0 + threadIdx.x;
    unsigned word[kG];
    int incl[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g)
      word[g] = g < ng && wi < wb1
                    ? __ldcg(a.mask + (size_t)act[g] * words + wi)
                    : 0u;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      incl[g] = __popc(word[g]);
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl[g], o);
        if (lane >= o) incl[g] += y;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int g = 0; g < kG; ++g) red[warp * kG + g] = incl[g];
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      int wbase = run[g], tot = 0;
      for (int w = 0; w < kWarps; ++w) {
        wbase += w < warp ? red[w * kG + g] : 0;
        tot += red[w * kG + g];
      }
      // this thread's word and its rows' first offset, read back below
      buf[g * kThreads + threadIdx.x] = (int)word[g];
      buf[(kG + g) * kThreads + threadIdx.x] =
          wbase + incl[g] - __popc(word[g]);
      run[g] += tot;
    }
#pragma unroll 1
    for (int g = 0; g < ng; ++g) {
      const unsigned word_g = (unsigned)buf[g * kThreads + threadIdx.x];
      const int excl = buf[(kG + g) * kThreads + threadIdx.x];
      int* ids = a.ids + (size_t)act[g] * n;
      // the warp's words that hold a member, one at a time, each lane one
      // row: coalesced (at depth most words are 0 and cost nothing)
      for (unsigned nz = __ballot_sync(kFull, word_g != 0u); nz;
           nz &= nz - 1u) {
        const int i = __ffs(nz) - 1;
        const unsigned wd = __shfl_sync(kFull, word_g, i);
        const int e = __shfl_sync(kFull, excl, i);
        if ((wd >> lane) & 1u)
          ids[e + __popc(wd & ((1u << lane) - 1u))] =
              (int)((w0 + warp * 32 + i) * 32 + lane);
      }
    }
    __syncthreads();  // red is reused
  }
  bclock<kTimed>(a, 23);
}

// Phase 4, element i of one model's child of `chunks` chunks: its
// partials summed in chunk order (eight loads in flight, the adds in
// order: reduce_child's sum), rounded once; sibling = parent - child in
// float32; both cache rows written.
__device__ __forceinline__ void reduce_elem(const double* partial,
                                            int chunks, size_t fb3,
                                            float* hist, int leaf,
                                            int idx_a, int idx_b, size_t i) {
  const double* pi = partial + i;
  double s = __ldcg(pi);
  int c = 1;
  for (; c + 7 < chunks; c += 8) {
    double p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = __ldcg(pi + (c + u) * fb3);
#pragma unroll
    for (int u = 0; u < 8; ++u) s += p[u];
  }
  for (; c < chunks; ++c) s += __ldcg(pi + c * fb3);
  const float child = (float)s;
  const float parent = __ldcg(hist + leaf * fb3 + i);
  hist[idx_a * fb3 + i] = child;
  hist[idx_b * fb3 + i] = parent - child;
}

// A block's walk over the virtual blocks of one phase, in increasing
// order: v -> (model m, index v - base in the model's own), the model
// advanced as v passes its count (count(m): the model's virtual blocks).
struct Walk {
  int m = 0;
  long long base = 0, count = -1;
  template <class C>
  __device__ __forceinline__ bool find(long long v, int models, C count_of) {
    for (;;) {
      if (count < 0) {
        if (m >= models) return false;
        count = count_of(m);
      }
      if (v < base + count) return true;
      base += count;
      count = -1;
      ++m;
    }
  }
};

// The timed instantiation's clock reads of one launch, block 0 / thread
// 0: a.times[slot] %globaltimer and a.times[8 + slot] clock64 at the
// kernel's entry (slot 0) and after each phase (1 sites, 2 lid pass, 3
// compaction, 4 histogram, 5 reduce, 6 its scans); slot 7 the latest ns
// at which a model's state was written (any block); [16, 20) block 0's
// histogram cycles (Laps); clock64 inside the lid pass (20: its walk
// ends, 21: its counts are written) and the compaction (22: the
// offsets are known, 23: the ids are written), before each grid sync.
template <bool kTimed>
__device__ __forceinline__ void bstamp(const BArgs& a, int slot,
                                       unsigned long long ns,
                                       unsigned long long cyc) {
  if constexpr (kTimed) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.times[slot] = ns;
      a.times[8 + slot] = cyc;
    }
  }
}

template <bool kTimed>
__device__ __forceinline__ void bstamp(const BArgs& a, int slot) {
  if constexpr (kTimed) bstamp<true>(a, slot, global_ns(), clock64());
}

template <typename BinT, int kCap, bool kTimed>
__global__ void __launch_bounds__(kThreads, 2)
split_step_leaf_batched_kernel(BArgs a) {
  const unsigned long long ns0 = kTimed ? global_ns() : 0;
  const unsigned long long cyc0 = kTimed ? clock64() : 0;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int iscratch[33];
  __shared__ int red[kWarps * 2 * kGroupModels];
  __shared__ int nact;
  __shared__ bool last;
  cg::grid_group grid = cg::this_grid();
  const BinT* bins = static_cast<const BinT*>(a.bins);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = a.F, B = a.B;
  const long long n = a.n;
  const size_t fb3 = (size_t)F * B * 3;
  const size_t lfb3 = (size_t)a.big_l * fb3;
  MState* ms = reinterpret_cast<MState*>(dyn + a.state_off);
  int* act = reinterpret_cast<int*>(ms + a.models);

  // ---- 0. every model's site, read by this block, kept in shared -----
  for (int m = warp; m < a.models; m += kWarps)
    read_site_warp(model_args(a, m), ms[m].s);
  __syncthreads();
  for (int m = threadIdx.x; m < a.models; m += kThreads) {
    const ltt::Site& s = ms[m].s;
    if (!s.go) continue;
    const int* im = a.imeta + s.feat * ltt::IM_COLS;
    const ltt::Pair q = ltt::derive_pair(model_args(a, m), s);
    ms[m].cut = Cut{s.leaf,           s.k,   q.small_left ? 1 : 0,
                    s.feat,           s.thr, s.dleft,
                    im[ltt::IM_MISS], im[ltt::IM_DEFBIN],
                    im[ltt::IM_NBINS]};
  }
  if (warp == 0) {  // the going models, in model order
    int cnt = 0;
    for (int m0 = 0; m0 < a.models; m0 += 32) {
      const int m = m0 + lane;
      const bool go = m < a.models && ms[m].s.go;
      const unsigned bal = __ballot_sync(kFull, go);
      if (go) act[cnt + __popc(bal & ((1u << lane) - 1u))] = m;
      cnt += __popc(bal);
    }
    if (lane == 0) nact = cnt;
  }
  __syncthreads();
  const int na = nact;
  if (na == 0) return;  // every block decides alike: no barrier skipped
  bstamp<kTimed>(a, 0, ns0, cyc0);
  bstamp<kTimed>(a, 1);

  // ---- 1. lid pass over this block's rows, the models together -------
  const long long per = ((n + gridDim.x - 1) / gridDim.x + 31) & ~31LL;
  const long long r0 = min(n, (long long)blockIdx.x * per);
  const long long r1 = min(n, r0 + per);
  for (int g0 = 0; g0 < na; g0 += kGroupModels) {
    const int ng = min(kGroupModels, na - g0);
    if (ng == 1)
      lid_group<BinT, 1, kTimed>(a, bins, ms, act + g0, ng, r0, r1, red);
    else if (ng == 2)
      lid_group<BinT, 2, kTimed>(a, bins, ms, act + g0, ng, r0, r1, red);
    else if (ng <= 4)
      lid_group<BinT, 4, kTimed>(a, bins, ms, act + g0, ng, r0, r1, red);
    else
      lid_group<BinT, 8, kTimed>(a, bins, ms, act + g0, ng, r0, r1, red);
  }
  grid.sync();
  bstamp<kTimed>(a, 2);

  // ---- 2. compaction: each model's child row ids, in row order (its
  // staging in the histogram's shared memory, free until phase 3) ----
  int* cbuf = reinterpret_cast<int*>(dyn);
  for (int g0 = 0; g0 < na; g0 += kGroupModels) {
    const int ng = min(kGroupModels, na - g0);
    if (ng == 1)
      compact_group<1, kTimed>(a, ms, act + g0, ng, r0, r1, red, cbuf);
    else if (ng == 2)
      compact_group<2, kTimed>(a, ms, act + g0, ng, r0, r1, red, cbuf);
    else if (ng <= 4)
      compact_group<4, kTimed>(a, ms, act + g0, ng, r0, r1, red, cbuf);
    else
      compact_group<8, kTimed>(a, ms, act + g0, ng, r0, r1, red, cbuf);
  }
  grid.sync();
  bstamp<kTimed>(a, 3);

  // ---- 3. histograms: (model, chunk, feature tile) virtual blocks ----
  const int nft = ltt::ids::feature_tiles(F, a.feat_tile);
  auto chunks_of = [&](int m) {
    return ms[m].s.go ? ltt::ids::child_chunks(ms[m].sc, a.max_chunks) : 0;
  };
  {
    const ltt::ids::TileSmem<BinT> tile =
        ltt::ids::carve<BinT>(dyn, a.feat_tile, B);
    Laps<kTimed> clk;
    Walk w;
    for (long long v = blockIdx.x;
         w.find(v, a.models,
                [&](int m) { return (long long)chunks_of(m) * nft; });
         v += gridDim.x) {
      clk.start();
      const int m = w.m, j = (int)(v - w.base);
      const ltt::Site& s = ms[m].s;
      const long long sc = ms[m].sc;
      const int chunks = chunks_of(m);
      const bool small_left = ms[m].cut.small_left != 0;
      hist_vblock<BinT, kTimed, kBatchedOwn>(
          a.ids + m * n, sc, (sc + chunks - 1) / chunks, chunks == 1,
          j / nft, j % nft, a.ghc + m * n * 3, bins, F, B, a.feat_tile, fb3,
          a.hist + m * lfb3, s.leaf, small_left ? s.leaf : s.k,
          small_left ? s.k : s.leaf, a.partial + m * a.max_chunks * fb3,
          tile, clk);
      clk.lap(3);
    }
    if constexpr (kTimed) {
      if (blockIdx.x == 0 && threadIdx.x == 0)
        for (int i = 0; i < 4; ++i) a.times[16 + i] = clk.acc[i];
    }
  }
  grid.sync();
  bstamp<kTimed>(a, 4);

  // ---- 4. the children of more than one chunk: (model, element) ------
  {
    bool any = false;
    for (int i = 0; i < na; ++i) any |= chunks_of(act[i]) > 1;
    if (any) {  // the same models on every block
      const long long gsize = (long long)gridDim.x * blockDim.x;
      for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
           i < (long long)na * (long long)fb3; i += gsize) {
        const int ai = (int)(i / (long long)fb3);
        const int m = act[ai];
        const int chunks = chunks_of(m);
        if (chunks < 2) continue;
        const ltt::Site& s = ms[m].s;
        const bool small_left = ms[m].cut.small_left != 0;
        reduce_elem(a.partial + m * a.max_chunks * fb3, chunks, fb3,
                    a.hist + m * lfb3, s.leaf, small_left ? s.leaf : s.k,
                    small_left ? s.k : s.leaf,
                    (size_t)(i - (long long)ai * (long long)fb3));
      }
      grid.sync();
    }
  }
  bstamp<kTimed>(a, 5);

  // ---- 5. scans: (model, child, feature) virtual blocks; the last of a
  // model's to count itself writes its state -----------------------------
  auto& scan_sm = *reinterpret_cast<ltt::ScanSmem<kCap>*>(dyn);
  Walk w;
  for (long long v = blockIdx.x;
       w.find(v, a.models,
              [&](int m) { return ms[m].s.go ? 2LL * F : 0LL; });
       v += gridDim.x) {
    const int m = w.m, j = (int)(v - w.base);
    const ltt::Site& s = ms[m].s;
    const MArgs ma = model_args(a, m);
    const ltt::Pair q = ltt::derive_pair(ma, s);
    scan_vblock<kCap, false>(a.hist + m * lfb3, F, B, j / F, j % F,
                             q.small_left ? s.leaf : s.k,
                             q.small_left ? s.k : s.leaf, q, a.imeta,
                             a.fmeta, ma.p, scan_sm, ma.table, nullptr);
    // thread 0 wrote the table row (scan_feature); the fence makes it
    // visible before the count that lets the model's last block read
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(a.done + m, 1) == 2 * F - 1;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      if (threadIdx.x == 0) a.done[m] = 0;
      ltt::finish_block(ma, s, q, 0, 0, 0, 0, iscratch);
      if constexpr (kTimed) {
        if (threadIdx.x == 0) atomicMax(a.times + 7, global_ns());
      }
    }
  }
  bstamp<kTimed>(a, 6);
}

// dynamic shared memory: the histogram tile (float64) and the staged
// rows, or the scan planes, whichever is larger
size_t leaf_smem_bytes(int bin_bytes, int B, int feat_tile,
                       size_t scan_bytes) {
  const size_t hist = ltt::ids::tile_smem_bytes(bin_bytes, B, feat_tile);
  return hist > scan_bytes ? hist : scan_bytes;
}

// where the batched kernel's models' state starts in its dynamic shared
// memory: past the single kernel's bytes (and the compaction's staging,
// kCompactBytes, which takes the histogram's bytes while they are free),
// 16-aligned
inline size_t batched_state_off(size_t single_smem) {
  const size_t b = single_smem > kCompactBytes ? single_smem : kCompactBytes;
  return (b + 15) & ~(size_t)15;
}

// Launch shape of one instance (the single kernel, or with kBatched
// the model-batched one): blocks per SM and grid, cached per (device,
// shared-memory size).
template <typename BinT, int kCap, bool kTimed, bool kBatched = false>
int leaf_grid(size_t smem, int* per_sm_out, int* grid_out) {
  static int dev_c = -1, per_sm_c = 0, grid_c = 0;
  static size_t smem_c = 0;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_c || smem != smem_c) {
    int err;
    if constexpr (kBatched)
      err = ltt::cooperative_grid(
          split_step_leaf_batched_kernel<BinT, kCap, kTimed>,
                                  kThreads, smem, &per_sm_c, &grid_c);
    else
      err = ltt::cooperative_grid(split_step_leaf_kernel<BinT, kCap, kTimed>,
                                  kThreads, smem, &per_sm_c, &grid_c);
    if (err) return err;
    dev_c = dev;
    smem_c = smem;
  }
  *per_sm_out = per_sm_c;
  *grid_out = grid_c;
  return 0;
}

// grid, shared memory and the chunk cap of one launch (the batched
// kernel of `models` models takes the single kernel's shared memory,
// rounded up to 16 bytes, and kModelSmem a model after it)
template <bool kTimed, bool kBatched = false>
int leaf_shape(int bin_bytes, int n, int F, int B, int feat_tile,
               int* out, int models = 0) {
  if (B < 1 || F < 1 || feat_tile < 1 || feat_tile > kMaxTile || n < 1 ||
      (bin_bytes == 1 && B > ltt::kMaxBins) ||
      (bin_bytes == 2 && B > ltt::kMaxScanBins) ||
      (bin_bytes != 1 && bin_bytes != 2))
    return (int)cudaErrorInvalidValue;
  if (kBatched && models < 1) return (int)cudaErrorInvalidValue;
  const size_t scan = bin_bytes == 1
                          ? sizeof(ltt::ScanSmem<ltt::kMaxBins>)
                          : sizeof(ltt::ScanSmem<ltt::kMaxScanBins>);
  size_t smem = leaf_smem_bytes(bin_bytes, B, feat_tile, scan);
  if (kBatched) smem = batched_state_off(smem) + (size_t)models * kModelSmem;
  int err;
  if (bin_bytes == 1)
    err = leaf_grid<uint8_t, ltt::kMaxBins, kTimed, kBatched>(smem, &out[0],
                                                              &out[1]);
  else
    err = leaf_grid<uint16_t, ltt::kMaxScanBins, kTimed, kBatched>(
        smem, &out[0], &out[1]);
  out[2] = (int)smem;
  out[3] = ltt::ids::max_chunks_of(F, feat_tile);
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

// the model-batched launch: every model's arrays hold `models` of the
// single launch's, one after another
template <bool kTimed>
int launch_leaf_batched(int bin_bytes, int models, int* k, float* S, float* T,
                        int* lid, float* hist, const void* bins,
                        const float* ghc, const int* imeta,
                        const float* fmeta, const float* params,
                        double* partial, unsigned* mask, int* ids,
                        int* counts, float* table, int* done, int n,
                        int big_l, int F, int B, int feat_tile, int grid_cap,
                        int has_mono, int max_depth,
                        unsigned long long* times, cudaStream_t stream) {
  int shape[4];
  const int err = leaf_shape<kTimed, true>(bin_bytes, n, F, B, feat_tile,
                                           shape, models);
  if (err) return err;
  // counts holds grid_cap ints a model, one per block
  if (big_l < 2 || shape[1] > grid_cap) return (int)cudaErrorInvalidValue;
  const size_t scan = bin_bytes == 1
                          ? sizeof(ltt::ScanSmem<ltt::kMaxBins>)
                          : sizeof(ltt::ScanSmem<ltt::kMaxScanBins>);
  const int state_off = (int)batched_state_off(
      leaf_smem_bytes(bin_bytes, B, feat_tile, scan));
  BArgs a{k,       S,         T,        lid,       hist,
          bins,    ghc,       imeta,    fmeta,     params,
          partial, mask,      ids,      counts,    table,
          done,    times,     models,   n,         big_l,
          F,       B,         feat_tile, shape[3], has_mono,
          has_mono ? 12 : 10, max_depth, state_off};
  void* args[] = {&a};
  const void* fn =
      bin_bytes == 1
          ? (const void*)split_step_leaf_batched_kernel<uint8_t,
                                                        ltt::kMaxBins, kTimed>
          : (const void*)split_step_leaf_batched_kernel<
                uint16_t, ltt::kMaxScanBins, kTimed>;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(shape[1]), dim3(kThreads), args, (size_t)shape[2], stream);
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

// The launch shape of the model-batched step of `models` models: as
// ltt_split_step_leaf_shape, for its own kernel (out[2]: the single
// step's shared bytes rounded up to 16, then kModelSmem a model).
LTT_EXPORT int ltt_split_step_leaf_batched_shape(int bin_bytes, int n, int F,
                                                 int B, int feat_tile,
                                                 int models, int* out) {
  return leaf_shape<false, true>(bin_bytes, n, F, B, feat_tile, out, models);
}

// Split k[m] of each of `models` models in one launch. Per model, one
// after another: k int32[1], S [nf + 7, L], T [9, L - 1], lid
// int32[n], hist [L, F, B, 3], ghc [n, 3], params f32[6] (l1, l2,
// max_delta_step, min_data, min_hess, min_gain), partial [max_chunks,
// F, B, 3] f64, mask u32[ceil(n / 32)], ids int32[n], counts
// int32[grid_cap], table [2, F, 8] f32, done int32[1] (0 before the
// first launch; each launch leaves it 0). Shared: bins [n, F] u8
// (bin_bytes 1) or u16 (2), imeta [F, 8] i32, fmeta [F, 2] f32.
LTT_EXPORT int ltt_split_step_leaf_batched(
    int bin_bytes, int models, int* k, float* S, float* T, int* lid,
    float* hist, const void* bins, const float* ghc, const int* imeta,
    const float* fmeta, const float* params, double* partial,
    unsigned* mask, int* ids, int* counts, float* table, int* done, int n,
    int big_l, int F, int B, int feat_tile, int grid_cap, int has_mono,
    int max_depth, cudaStream_t stream) {
  return launch_leaf_batched<false>(
      bin_bytes, models, k, S, T, lid, hist, bins, ghc, imeta, fmeta, params,
      partial, mask, ids, counts, table, done, n, big_l, F, B, feat_tile,
      grid_cap, has_mono, max_depth, nullptr, stream);
}

// The timed instantiation of the model-batched step (chip_profile.py
// only): the same launch, and block 0 writes its clock reads into times
// (u64 [32], this launch's row; see bstamp).
LTT_EXPORT int ltt_split_step_leaf_batched_timed(
    int bin_bytes, int models, int* k, float* S, float* T, int* lid,
    float* hist, const void* bins, const float* ghc, const int* imeta,
    const float* fmeta, const float* params, double* partial,
    unsigned* mask, int* ids, int* counts, float* table, int* done, int n,
    int big_l, int F, int B, int feat_tile, int grid_cap, int has_mono,
    int max_depth, unsigned long long* times, cudaStream_t stream) {
  return launch_leaf_batched<true>(
      bin_bytes, models, k, S, T, lid, hist, bins, ghc, imeta, fmeta, params,
      partial, mask, ids, counts, table, done, n, big_l, F, B, feat_tile,
      grid_cap, has_mono, max_depth, times, stream);
}
