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
// parent's segment read once and written once (the smaller child's
// histogram can come from rows already being read) and three cache
// rows, 2 * cnt * stride + 3 * F * B * 12 bytes at 3.35 TB/s. This
// kernel moves more: the partition scatters to the workspace and copies
// back, and the histogram phase reads the smaller child's rows again.
// For small leaves the grid-wide barriers between the phases dominate.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), the
// grid sized from the occupancy so every block is resident, and
// cooperative_groups grid syncs between the phases. The work of each
// phase is cut into virtual blocks that the physical blocks walk.
//  0. every block reads the split site from S (first-index argmax of
//     the open leaves' bs_gain, then the leaf's column);
//  1. partition (partition_core.cuh, shared with partition_segment.cu):
//     left count per 256-row tile | sync | one block scans the tile
//     counts, NL | sync | stable scatter of lefts to ws[0, NL) and
//     rights to ws[NL, cnt) | sync. Scattering lefts in place into mat
//     would race: a block may overwrite rows another block has not read
//     yet, since blocks run in no order.
//  2. copy ws back to mat, and, from ws, the smaller child's histogram
//     (hist_tile.cuh, shared with hist_segment.cu) with the per-phase
//     kernel's launch shape: ceil(parent cnt / 4096) row chunks, at
//     most 264, each a virtual block writing its own partial | sync;
//  3. partials summed in chunk order, as hist_segment.cu's reduce does,
//     so the child's histogram is bitwise the per-phase kernel's; the
//     sibling is parent - child; both cache rows written | sync; both
//     children's scans (scan_core.cuh, shared with split_scan.cu), one
//     virtual block per (child, feature) | sync;
//  4. block 0: first-index best feature per child, both S columns, the
//     T column and the parent-pointer fixup, k + 1 (split_state.cuh,
//     shared with split_step_leaf.cu).
// No float atomics: the result is bitwise reproducible. Compiled with
// -fmad=false: the scan, the leaf outputs and the subtraction follow
// the plain version's float32 expression order.
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
constexpr int kRowsPerVBlock = 4096;  // hist_cuda.ROWS_PER_BLOCK
constexpr int kMaxVBlocks = 264;      // hist_cuda.MAX_BLOCKS

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
  float* partial;  // [kMaxVBlocks, F, B, 3]
  int* tiles;      // [ceil(rows / 256)] tile left counts -> offsets
  float* table;    // [2, F, 8] scan tables of the two children
  int* ctl;        // [0] = NL
  int big_l, F, B, feat_tile, has_mono, nf, si0, max_depth;
  ltt::Params p;
};

__global__ void __launch_bounds__(kThreads, 2)
split_step_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ ltt::ScanSmem<ltt::kMaxBins> scan_sm;
  __shared__ ltt::Site site;
  __shared__ int iscratch[33];
  __shared__ float fscratch[kThreads / 32];
  cg::grid_group grid = cg::this_grid();

  // ---- 0. the split site ---------------------------------------------
  ltt::read_site(a, site, fscratch, iscratch);
  if (!site.go) return;  // every block decides alike: no barrier skipped
  const int F = a.F, B = a.B, stride = a.stride;
  const int* im = a.imeta + site.feat * ltt::IM_COLS;
  const ltt::Decision d{site.feat, site.thr, site.dleft, im[ltt::IM_MISS],
                        im[ltt::IM_DEFBIN], im[ltt::IM_NBINS], 0, nullptr};
  const long long begin = site.begin, cnt = site.cnt;
  const int ntiles = (int)((cnt + ltt::kPartRows - 1) / ltt::kPartRows);

  // ---- 1. stable partition of [begin, begin + cnt) into ws -----------
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int left = ltt::tile_left_count(a.mat, stride, begin, cnt, t, d);
    if (threadIdx.x == 0) a.tiles[t] = left;
  }
  grid.sync();
  if (blockIdx.x == 0) {
    const int nl = ltt::block_exclusive_scan(a.tiles, ntiles, iscratch);
    if (threadIdx.x == 0) a.ctl[0] = nl;
  }
  grid.sync();
  const int nl = a.ctl[0];
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
    ltt::tile_scatter(a.mat, a.ws, stride, begin, cnt, t, d, a.tiles[t], nl,
                      iscratch);
  grid.sync();

  // ---- 2. copy back; the smaller child's histogram from ws -----------
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  {
    const long long nvec = cnt * (stride / 16);
    const int4* src = reinterpret_cast<const int4*>(a.ws);
    int4* dst = reinterpret_cast<int4*>(a.mat + (size_t)begin * stride);
    for (long long i = gtid; i < nvec; i += gsize) dst[i] = src[i];
  }
  const ltt::Pair q = ltt::derive_pair(a, site);
  const long long sb = q.small_left ? 0 : nl;  // relative to ws row 0
  const long long sc = q.small_left ? nl : cnt - nl;
  const int nblk = (int)min((long long)kMaxVBlocks,
                            max(1LL, (cnt + kRowsPerVBlock - 1) /
                                         kRowsPerVBlock));
  const int nft = (F + a.feat_tile - 1) / a.feat_tile;
  const long long chunk = (sc + nblk - 1) / nblk;
  float* stage = smem + (size_t)a.feat_tile * B * 3;
  for (int v = blockIdx.x; v < nblk * nft; v += gridDim.x) {
    const int vb = v / nft, f0 = (v % nft) * a.feat_tile;
    const int nf = min(a.feat_tile, F - f0);
    const int n3 = nf * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads) smem[i] = 0.f;
    const long long r0 = min(sc, (long long)vb * chunk);
    const long long r1 = min(sc, r0 + chunk);
    __syncthreads();
    ltt::hist_rows<false>(a.ws, sb, stride, a.pay_off, r0, r1, f0, nf, B,
                          smem, stage);
    float* dst = a.partial + ((size_t)vb * F + f0) * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads) dst[i] = smem[i];
    __syncthreads();
  }
  grid.sync();

  // ---- 3. child = sum of partials in chunk order; sibling = parent - child
  const int n3 = F * B * 3;
  const int leaf = site.leaf;
  const int idx_a = q.small_left ? leaf : site.k;
  const int idx_b = q.small_left ? site.k : leaf;
  for (long long i = gtid; i < n3; i += gsize) {
    float s = a.partial[i];
    for (int b = 1; b < nblk; ++b) s += a.partial[(size_t)b * n3 + i];
    const float parent = a.hist[(size_t)leaf * n3 + i];
    a.hist[(size_t)idx_a * n3 + i] = s;
    a.hist[(size_t)idx_b * n3 + i] = parent - s;
  }
  grid.sync();
  for (int v = blockIdx.x; v < 2 * F; v += gridDim.x) {
    const int c = v / F, f = v % F;
    const float* h = a.hist + ((size_t)(c == 0 ? idx_a : idx_b) * F + f) *
                                  B * 3;
    const int* mf = a.imeta + f * ltt::IM_COLS;
    ltt::scan_feature(h, B, c == 0 ? q.a : q.b, mf[ltt::IM_NBINS],
                      mf[ltt::IM_MISS], mf[ltt::IM_DEFBIN], mf[ltt::IM_MONO],
                      a.fmeta[f * 2 + 0], a.fmeta[f * 2 + 1], a.p, scan_sm,
                      a.table + ((size_t)c * F + f) * 8);
  }
  grid.sync();

  // ---- 4. state, tree arrays, k ---------------------------------------
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int cnt_a = q.small_left ? nl : site.cnt - nl;
    const int begin_a = q.small_left ? site.begin : site.begin + nl;
    const int begin_b = q.small_left ? site.begin + nl : site.begin;
    ltt::finish(a, site, q, begin_a, cnt_a, begin_b, site.cnt - cnt_a);
  }
}

size_t step_smem_bytes(int B, int feat_tile) {
  return ltt::hist_smem_floats(feat_tile, B) * sizeof(float);
}

// Blocks per SM and grid size for this shared-memory size; cached.
int step_grid(size_t smem, int* per_sm_out, int* grid_out) {
  static int dev_c = -1, per_sm_c = 0, grid_c = 0;
  static size_t smem_c = 0;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_c || smem != smem_c) {
    const int err = ltt::cooperative_grid(split_step_kernel, kThreads, smem,
                                          &per_sm_c, &grid_c);
    if (err) return err;
    dev_c = dev;
    smem_c = smem;
  }
  *per_sm_out = per_sm_c;
  *grid_out = grid_c;
  return 0;
}

}  // namespace

// The launch shape the fused step would take: out[0] blocks per SM,
// out[1] grid size, out[2] dynamic shared-memory bytes per block.
LTT_EXPORT int ltt_split_step_shape(int B, int feat_tile, int* out) {
  const size_t smem = step_smem_bytes(B, feat_tile);
  const int err = step_grid(smem, &out[0], &out[1]);
  out[2] = (int)smem;
  return err;
}

// k: device int32[1]; S [nf + 9, L], T [9, L - 1] f32; mat/ws u8
// [rows, stride]; hist [L, F, B, 3]; imeta [F, 8] i32, fmeta [F, 2] f32;
// partial [264, F, B, 3] f32, tiles int32[ceil(rows / 256)],
// table [2, F, 8] f32, ctl int32[4] scratch.
LTT_EXPORT int ltt_split_step_segment(
    int* k, float* S, float* T, uint8_t* mat, uint8_t* ws, int stride,
    int pay_off, float* hist, const int* imeta, const float* fmeta,
    float* partial, int* tiles, float* table, int* ctl, int big_l, int F,
    int B, int feat_tile, int has_mono, int max_depth, float l1, float l2,
    float mds, float min_data, float min_hess, float min_gain,
    cudaStream_t stream) {
  if (B < 1 || B > ltt::kMaxBins || F < 1 || feat_tile < 1 || big_l < 2 ||
      stride % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem_bytes(B, feat_tile);
  int per_sm = 0, grid = 0;
  const int err = step_grid(smem, &per_sm, &grid);
  if (err) return err;
  Args a{k,       S,        T,     mat,     ws,        stride,
         pay_off, hist,     imeta, fmeta,   partial,   tiles,
         table,   ctl,      big_l, F,       B,         feat_tile,
         has_mono, has_mono ? 12 : 10, 2, max_depth,
         ltt::Params{l1, l2, mds, min_data, min_hess, min_gain}};
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)split_step_kernel, dim3(grid), dim3(kThreads), params,
      smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
