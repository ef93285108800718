// One whole split of the partitioned grow loop as one launch on Hopper.
//
// Replaces the TPU kernel fused_split_step_segment
// (lightgbm_tpu/ops/split_step_pallas.py:531: Mosaic body
// _segment_kernel_tpu :1224, interpret twin _segment_kernel_ref :282).
// One launch does the whole split: pick the best open leaf from the
// merged state matrix S, stable-partition its segment of the training
// matrix, build the smaller child's histogram, get the sibling as
// parent - child, scan both children, and write both S columns, the
// tree-array column of T (with the parent-pointer fixup) and both rows
// of the per-leaf histogram cache. The split index k lives on the
// device: the kernel reads it, checks the grow loop's condition
// (k < L and the best open gain > 0; lightgbm_tpu/learner/
// partitioned.py:563-568) and increments it, and changes nothing when
// the condition fails. So the host enqueues all L - 1 launches of a
// tree without reading anything back.
//
// Layouts: S [Ks, L] f32 and T [Kt, L - 1] f32 are the JAX package's
// merged StatePack (lightgbm_tpu_torch/learner/split_step.py
// make_grow_pack, segment prefix), int rows as f32 bit patterns
// (__float_as_int, never a conversion). hist is the [L, F, B, 3] cache.
// imeta [F, 8] i32 / fmeta [F, 2] f32 are pack_meta_tables'.
//
// What bounds it on the H100: memory traffic. A split needs the
// parent's segment read once and written once and three cache rows,
// 2 * cnt * stride + 3 * F * B * 12 bytes at 3.35 TB/s; the smaller
// child's rows are read once more for its histogram, from L2 where the
// segment fits there. For small leaves the grid-wide barriers between
// the phases and the histogram's latency dominate.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), the
// grid sized from the occupancy so every block is resident, and
// cooperative_groups grid syncs between the phases. Past the partition,
// every phase's work scales with the smaller child's row count sc.
//  0. every block reads the split site from S (first-index argmax of
//     the open leaves' bs_gain, then the leaf's column);
//  1. stable partition, each block over its own contiguous range of the
//     segment. Held (the segment fits the grid's registers: up to
//     kHoldVecs 16-byte vectors a thread, 4 rows of 48 bytes): each
//     thread loads its rows into registers and decides their side,
//     each block writes its left count | sync | each block sums the
//     block counts before it (every block reads them itself: no block
//     scans for the others) and writes its rows straight to their final
//     places in the matrix, from registers | sync. Every row was read
//     before the first sync, so writing in place races with no read.
//     A larger segment goes through the workspace: left count per
//     256-row tile and per block | sync | stable scatter of each tile
//     to ws (lefts to [0, NL), rights to [NL, cnt)) | sync, and the
//     copy back to the matrix runs beside the histogram phase;
//  2. the smaller child's histogram (hist_tile.cuh, shared with
//     hist_segment.cu): child_chunks(sc, F) chunks, from sc and F
//     alone, summed in float64, so the sums are those of the per-phase
//     kernel on any card. (chunk, 8-feature tile) virtual blocks spread
//     over the grid, one feature a warp. A child of one chunk rounds its tile once and writes its cache
//     row and parent - child straight from it; otherwise each chunk
//     writes a float64 partial | sync;
//  3. (more than one chunk) partials summed in chunk order and rounded
//     once, as hist_segment.cu's reduce does; the sibling is parent -
//     child in float32; both cache rows written | sync;
//  4. both children's scans (scan_core.cuh, shared with split_scan.cu),
//     one virtual block per (child, feature), the planes in the
//     histogram's shared memory; each block then counts itself done;
//  5. the last block to count: both S columns, the T column and the
//     parent-pointer fixup, k + 1 (split_state.cuh finish_block, shared
//     with split_step_leaf.cu), and the count back to 0 for the next
//     launch.
// So a split has 3 grid syncs when its smaller child is one chunk, 4
// otherwise. No float atomics: the result is bitwise reproducible. Data
// another block wrote in this launch is read with __ldcg (L2, not a
// possibly stale L1 line). Compiled with -fmad=false: the scan, the
// leaf outputs and the subtraction follow the plain version's float32
// expression order.
//
// A second instantiation (kTimed, launched by chip_profile.py only)
// has block 0 record %globaltimer and clock64 after each phase.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "hist_tile.cuh"
#include "partition_core.cuh"
#include "scan_core.cuh"
#include "split_state.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHoldVecs = 12;  // 16-byte vectors a thread holds (held path)
constexpr int kMaxHold = kHoldVecs / 2;  // rows a thread holds, at most
constexpr int kTimes = 32;     // clock reads per split (timed build)
constexpr int kReduceBatch = 8;  // partials' loads in flight (reduce)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int* k;  // device int32[1]: the split index (= the new leaf's id)
  float* S;
  float* T;
  uint8_t* mat;
  uint8_t* ws;
  int stride, pay_off;
  float* hist;
  const int* imeta;
  const float* fmeta;
  double* partial;  // [max_chunks(F), F, B, 3]
  int* tiles;      // [ceil(rows / 256)] tile left counts (workspace path)
  int* counts;     // [grid] left rows per block
  float* table;    // [2, F, 8] scan tables of the two children
  int* done;       // [1] blocks past their scans; 0 between launches
  unsigned long long* times;  // timed instantiation: [L - 1, kTimes]
  int big_l, F, B, has_mono, nf, si0, max_depth;
  ltt::Params p;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The timed instantiation's clock reads, block 0 / thread 0 only: row
// k - 1 of a.times holds %globaltimer in slot i and clock64 in slot
// 16 + i, at the kernel's entry (slot 0) and after each phase: 1 site,
// 2 count pass, 3 scatter, 4 histogram, 5 reduce (as 4 for a one-chunk
// child), 6 its scans; slot 15 holds the ns after the state is written
// (by the last block). Slots 24-26 hold block 0's histogram cycles
// (zeroing, rows, write-out), 27 its virtual blocks, and 28-29 the rows'
// cycles split into staging (waiting for the rows' loads, storing them
// to shared memory) and accumulation.
template <bool kTimed>
__device__ __forceinline__ void stamp(const Args& a, int k, int slot,
                                      unsigned long long ns,
                                      unsigned long long cyc) {
  if constexpr (kTimed) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.times[(size_t)(k - 1) * kTimes + slot] = ns;
      a.times[(size_t)(k - 1) * kTimes + 16 + slot] = cyc;
    }
  }
}

template <bool kTimed>
__device__ __forceinline__ void stamp(const Args& a, int k, int slot) {
  if constexpr (kTimed) stamp<true>(a, k, slot, global_ns(), clock64());
}

// cycles since the last lap into acc (timed build, thread 0's view)
template <bool kTimed>
struct Laps {
  unsigned long long t = 0, acc[5] = {0, 0, 0, 0, 0};
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

// After the counts sync: the left rows of the blocks before this one
// (*before) and of the whole segment (the return value). The counts
// come from other blocks of this launch: read from L2.
__device__ __forceinline__ int lefts_before(const Args& a, int* before,
                                            int* red) {
  int bef = 0, all = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    const int c = __ldcg(a.counts + j);
    all += c;
    bef += j < (int)blockIdx.x ? c : 0;
  }
  *before = block_sum(bef, red);
  return block_sum(all, red);
}

// The split feature's bin of a row held in registers (vectors v[0, VPR)):
// a select chain, so v stays in registers
template <int VPR>
__device__ __forceinline__ int held_bin(const int4 (&v)[VPR], int feat) {
  const int vi = feat >> 4, wi = (feat >> 2) & 3, sh = 8 * (feat & 3);
  int w = 0;
#pragma unroll
  for (int j = 0; j < VPR; ++j)
    if (j == vi)
      w = wi == 0 ? v[j].x : wi == 1 ? v[j].y : wi == 2 ? v[j].z : v[j].w;
  return (w >> sh) & 0xff;
}

// The held partition (see the note above); VPR = stride / 16. Returns
// NL. wl: shared int[kMaxHold * kWarps].
template <int VPR, bool kTimed>
__device__ __forceinline__ int held_partition(const Args& a,
                                              cg::grid_group& grid, int k,
                                              long long begin, long long cnt,
                                              const ltt::Decision& d,
                                              int* wl, int* red) {
  constexpr int R = kHoldVecs / VPR;  // rows a thread holds
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (cnt + gridDim.x - 1) / gridDim.x;  // <= 256 R
  const long long lo = min(cnt, (long long)blockIdx.x * per);
  const int len = (int)(min(cnt, lo + per) - lo);
  const int stride = a.stride;
  int4 v[R][VPR];
  unsigned bl[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int r = u * kThreads + threadIdx.x;
    bool left = false;
    if (r < len) {
      const int4* row = reinterpret_cast<const int4*>(
          a.mat + (size_t)(begin + lo + r) * stride);
#pragma unroll
      for (int j = 0; j < VPR; ++j) v[u][j] = row[j];
      left = ltt::go_left(held_bin<VPR>(v[u], d.feat), d);
    }
    bl[u] = __ballot_sync(kFull, left);
    if (lane == 0) wl[u * kWarps + warp] = __popc(bl[u]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // exclusive prefix over (u, warp): lefts before each 32-row group
    int run = 0;
    for (int i = 0; i < R * kWarps; ++i) {
      const int x = wl[i];
      wl[i] = run;
      run += x;
    }
    a.counts[blockIdx.x] = run;
  }
  grid.sync();
  stamp<kTimed>(a, k, 2);
  int before;
  const int nl = lefts_before(a, &before, red);  // syncs the block
  const unsigned lt = (1u << lane) - 1u;
  const long long rights0 = (long long)nl + (lo - before);
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int r = u * kThreads + threadIdx.x;
    if (r >= len) continue;
    const int lb = wl[u * kWarps + warp];  // the block's lefts before
    const bool left = (bl[u] >> lane) & 1u;
    // rows r' < r of the block are all valid (its range is contiguous)
    const long long dest =
        left ? (long long)before + lb + __popc(bl[u] & lt)
             : rights0 + (u * kThreads + warp * 32 - lb) +
                   __popc(~bl[u] & lt);
    int4* dst = reinterpret_cast<int4*>(a.mat + (size_t)(begin + dest) *
                                                    stride);
#pragma unroll
    for (int j = 0; j < VPR; ++j) dst[j] = v[u][j];
  }
  return nl;
}

// The workspace partition (see the note above): each block over its
// own contiguous run of 256-row tiles. Returns NL.
template <bool kTimed>
__device__ __forceinline__ int ws_partition(const Args& a,
                                            cg::grid_group& grid, int k,
                                            long long begin, long long cnt,
                                            const ltt::Decision& d,
                                            int* red) {
  const long long ntiles = (cnt + ltt::kPartRows - 1) / ltt::kPartRows;
  const long long per = (ntiles + gridDim.x - 1) / gridDim.x;
  const long long t_lo = min(ntiles, (long long)blockIdx.x * per);
  const long long t_hi = min(ntiles, t_lo + per);
  int mine = 0;
  for (long long t = t_lo; t < t_hi; ++t) {
    const int left =
        ltt::tile_left_count(a.mat, a.stride, begin, cnt, (int)t, d);
    if (threadIdx.x == 0) a.tiles[t] = left;
    mine += left;
  }
  if (threadIdx.x == 0) a.counts[blockIdx.x] = mine;
  grid.sync();
  stamp<kTimed>(a, k, 2);
  int run;
  const int nl = lefts_before(a, &run, red);
  for (long long t = t_lo; t < t_hi; ++t) {
    const int left = __ldcg(a.tiles + t);
    ltt::tile_scatter(a.mat, a.ws, a.stride, begin, cnt, (int)t, d, run, nl,
                      red);
    run += left;
  }
  return nl;
}

template <bool kTimed>
__global__ void __launch_bounds__(kThreads, 2)
split_step_kernel(Args a) {
  const unsigned long long ns0 = kTimed ? global_ns() : 0;
  const unsigned long long cyc0 = kTimed ? clock64() : 0;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ ltt::Site site;
  __shared__ int iscratch[33];
  __shared__ int wl[kMaxHold * kWarps];
  __shared__ float fscratch[kWarps];
  __shared__ bool last;
  cg::grid_group grid = cg::this_grid();

  // ---- 0. the split site ---------------------------------------------
  ltt::read_site(a, site, fscratch, iscratch);
  if (!site.go) return;  // every block decides alike: no barrier skipped
  stamp<kTimed>(a, site.k, 0, ns0, cyc0);
  stamp<kTimed>(a, site.k, 1);
  const int F = a.F, B = a.B, stride = a.stride;
  const int* im = a.imeta + site.feat * ltt::IM_COLS;
  const ltt::Decision d{site.feat, site.thr, site.dleft, im[ltt::IM_MISS],
                        im[ltt::IM_DEFBIN], im[ltt::IM_NBINS], 0, nullptr};
  const long long begin = site.begin, cnt = site.cnt;

  // ---- 1. stable partition of [begin, begin + cnt) -------------------
  const int vpr = stride / 16;
  const bool held = vpr <= 4 && cnt <= (long long)gridDim.x * kThreads *
                                           (kHoldVecs / vpr);
  // (each path syncs the grid after its count pass, then scatters)
  const int kk = site.k;
  int nl;
  if (held)
    nl = vpr == 2 ? held_partition<2, kTimed>(a, grid, kk, begin, cnt, d, wl,
                                              iscratch)
         : vpr == 3
             ? held_partition<3, kTimed>(a, grid, kk, begin, cnt, d, wl,
                                         iscratch)
             : held_partition<4, kTimed>(a, grid, kk, begin, cnt, d, wl,
                                         iscratch);
  else
    nl = ws_partition<kTimed>(a, grid, kk, begin, cnt, d, iscratch);
  grid.sync();
  stamp<kTimed>(a, site.k, 3);

  // ---- 2. the smaller child's histogram ------------------------------
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  if (!held) {  // the workspace back to the matrix, beside the histogram
    const long long nvec = cnt * vpr;
    const int4* wsv = reinterpret_cast<const int4*>(a.ws);
    int4* dst = reinterpret_cast<int4*>(a.mat + (size_t)begin * stride);
    for (long long i = gtid; i < nvec; i += gsize) dst[i] = __ldcg(wsv + i);
  }
  const ltt::Pair q = ltt::derive_pair(a, site);
  const long long s_off = q.small_left ? 0 : nl;  // segment-relative
  const long long sc = q.small_left ? nl : cnt - nl;
  // the child's rows: in the matrix (held) or in the workspace
  const uint8_t* src = held ? a.mat : a.ws;
  const long long sbase = held ? begin + s_off : s_off;
  const int chunks = ltt::child_chunks(sc, F);
  const bool direct = chunks == 1;
  const int tw = ltt::kTileFeatures;
  const int nft = ltt::feature_tiles(F);
  const long long chunk = (sc + chunks - 1) / chunks;
  const int leaf = site.leaf;
  const int idx_a = q.small_left ? leaf : site.k;
  const int idx_b = q.small_left ? site.k : leaf;
  const size_t fb3 = (size_t)F * B * 3;
  {
    double* hist_s = reinterpret_cast<double*>(dyn);
    unsigned char* stage = dyn + (size_t)tw * B * 24;
    Laps<kTimed> clk;
    int nv = 0;
    for (int v = blockIdx.x; v < chunks * nft; v += gridDim.x) {
      clk.start();
      ++nv;
      const int c = v / nft, f0 = (v % nft) * tw;
      const int nf = min(tw, F - f0);
      const int n3 = nf * B * 3;
      for (int i = threadIdx.x; i < n3; i += kThreads) hist_s[i] = 0.0;
      const long long r0 = min(sc, (long long)c * chunk);
      const long long r1 = min(sc, r0 + chunk);
      clk.lap(0);
      ltt::hist_rows<true, kTimed>(src, sbase, stride, a.pay_off, r0, r1,
                                   f0, nf, B, hist_s, stage,
                                   kTimed ? clk.acc + 3 : nullptr);
      clk.lap(1);
      const size_t off = (size_t)f0 * B * 3;
      if (direct) {
        // the tile of the whole child, rounded once, into the cache
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
      clk.lap(2);
    }
    if constexpr (kTimed) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        unsigned long long* row = a.times + (size_t)(site.k - 1) * kTimes;
        for (int i = 0; i < 3; ++i) row[24 + i] = clk.acc[i];
        row[27] = nv;
        row[28] = clk.acc[3];
        row[29] = clk.acc[4];
      }
    }
  }
  grid.sync();
  stamp<kTimed>(a, site.k, 4);

  // ---- 3. child = partials in chunk order, rounded once; sibling ----
  if (!direct) {
    for (long long i = gtid; i < (long long)fb3; i += gsize) {
      // in chunk order, kReduceBatch partials' loads in flight at a time
      const double* pi = a.partial + i;
      double s = __ldcg(pi);
      int c = 1;
      for (; c + kReduceBatch <= chunks; c += kReduceBatch) {
        double p[kReduceBatch];
#pragma unroll
        for (int u = 0; u < kReduceBatch; ++u)
          p[u] = __ldcg(pi + (c + u) * fb3);
#pragma unroll
        for (int u = 0; u < kReduceBatch; ++u) s += p[u];
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

  // ---- 4. both children's scans (the planes reuse the histogram's
  // shared memory, free after the sync above) --------------------------
  auto& scan_sm = *reinterpret_cast<ltt::ScanSmem<ltt::kMaxBins>*>(dyn);
  for (int v = blockIdx.x; v < 2 * F; v += gridDim.x) {
    const int c = v / F, f = v % F;
    const float* h = a.hist + ((c == 0 ? idx_a : idx_b) * (size_t)F + f) *
                                  B * 3;
    const int* mf = a.imeta + f * ltt::IM_COLS;
    ltt::scan_feature(h, B, c == 0 ? q.a : q.b, mf[ltt::IM_NBINS],
                      mf[ltt::IM_MISS], mf[ltt::IM_DEFBIN], mf[ltt::IM_MONO],
                      a.fmeta[f * 2 + 0], a.fmeta[f * 2 + 1], a.p, scan_sm,
                      a.table + ((size_t)c * F + f) * 8);
  }
  stamp<kTimed>(a, site.k, 6);

  // ---- 5. state, tree arrays, k: the last block past its scans -------
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
  const int cnt_a = (int)sc;
  const int begin_a = site.begin + (int)s_off;
  const int begin_b = q.small_left ? site.begin + nl : site.begin;
  ltt::finish_block(a, site, q, begin_a, cnt_a, begin_b, site.cnt - cnt_a,
                    iscratch);
  if constexpr (kTimed) {
    if (threadIdx.x == 0)
      a.times[(size_t)(site.k - 1) * kTimes + 15] = global_ns();
  }
}

// dynamic shared memory: the histogram tile (float64) and one staged
// step of rows, or the scan planes, whichever is larger
size_t step_smem_bytes(int B) {
  const size_t hist = ltt::hist_smem_bytes(B);
  const size_t scan = sizeof(ltt::ScanSmem<ltt::kMaxBins>);
  return hist > scan ? hist : scan;
}

// Blocks per SM and grid size for this shared-memory size; cached per
// instantiation.
template <bool kTimed>
int step_grid(size_t smem, int* per_sm_out, int* grid_out) {
  static int dev_c = -1, per_sm_c = 0, grid_c = 0;
  static size_t smem_c = 0;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_c || smem != smem_c) {
    const int err = ltt::cooperative_grid(split_step_kernel<kTimed>,
                                          kThreads, smem, &per_sm_c,
                                          &grid_c);
    if (err) return err;
    dev_c = dev;
    smem_c = smem;
  }
  *per_sm_out = per_sm_c;
  *grid_out = grid_c;
  return 0;
}

template <bool kTimed>
int launch_step(int* k, float* S, float* T, uint8_t* mat, uint8_t* ws,
                int stride, int pay_off, float* hist, const int* imeta,
                const float* fmeta, double* partial, int* tiles, int* counts,
                float* table, int* done, unsigned long long* times,
                int big_l, int F, int B, int grid_cap, int has_mono,
                int max_depth, ltt::Params p, cudaStream_t stream) {
  if (B < 1 || B > ltt::kMaxBins || F < 1 || big_l < 2 || stride % 16 ||
      pay_off % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem_bytes(B);
  int per_sm = 0, grid = 0;
  const int err = step_grid<kTimed>(smem, &per_sm, &grid);
  if (err) return err;
  if (grid > grid_cap) return (int)cudaErrorInvalidValue;  // counts' size
  Args a{k,       S,      T,     mat,       ws,      stride,
         pay_off, hist,   imeta, fmeta,     partial, tiles,
         counts,  table,  done,  times,     big_l,   F,
         B,       has_mono, has_mono ? 12 : 10, 2, max_depth, p};
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)split_step_kernel<kTimed>, dim3(grid), dim3(kThreads),
      params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape the fused step would take: out[0] blocks per SM,
// out[1] grid size, out[2] dynamic shared-memory bytes per block.
LTT_EXPORT int ltt_split_step_shape(int B, int* out) {
  if (B < 1 || B > ltt::kMaxBins) return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem_bytes(B);
  const int err = step_grid<false>(smem, &out[0], &out[1]);
  out[2] = (int)smem;
  return err;
}

// k: device int32[1]; S [nf + 9, L], T [9, L - 1] f32; mat/ws u8
// [rows, stride]; hist [L, F, B, 3]; imeta [F, 8] i32, fmeta [F, 2] f32;
// partial [max_chunks(F), F, B, 3] f64, tiles int32[ceil(rows / 256)],
// counts int32[grid_cap] (grid_cap >= the grid), table [2, F, 8] f32,
// done int32[1] (0 before the first launch; each launch leaves it 0).
LTT_EXPORT int ltt_split_step_segment(
    int* k, float* S, float* T, uint8_t* mat, uint8_t* ws, int stride,
    int pay_off, float* hist, const int* imeta, const float* fmeta,
    double* partial, int* tiles, int* counts, float* table, int* done,
    int big_l, int F, int B, int grid_cap, int has_mono,
    int max_depth, float l1, float l2, float mds, float min_data,
    float min_hess, float min_gain, cudaStream_t stream) {
  return launch_step<false>(
      k, S, T, mat, ws, stride, pay_off, hist, imeta, fmeta, partial, tiles,
      counts, table, done, nullptr, big_l, F, B, grid_cap,
      has_mono, max_depth,
      ltt::Params{l1, l2, mds, min_data, min_hess, min_gain}, stream);
}

// The timed instantiation (chip_profile.py only): the same split, and
// block 0 writes its clock reads of split k into row k - 1 of times
// (u64 [L - 1, 32]; see stamp).
LTT_EXPORT int ltt_split_step_segment_timed(
    int* k, float* S, float* T, uint8_t* mat, uint8_t* ws, int stride,
    int pay_off, float* hist, const int* imeta, const float* fmeta,
    double* partial, int* tiles, int* counts, float* table, int* done,
    int big_l, int F, int B, int grid_cap, int has_mono,
    int max_depth, float l1, float l2, float mds, float min_data,
    float min_hess, float min_gain, unsigned long long* times,
    cudaStream_t stream) {
  return launch_step<true>(
      k, S, T, mat, ws, stride, pay_off, hist, imeta, fmeta, partial, tiles,
      counts, table, done, times, big_l, F, B, grid_cap,
      has_mono, max_depth,
      ltt::Params{l1, l2, mds, min_data, min_hess, min_gain}, stream);
}
