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
// ghc, and read one cache row and write two. This kernel moves more: the
// smaller child's ghc once per feature tile, the mask once per tile,
// and per-chunk float64 partials [nchunks, F, B, 3] written and read
// back in the reduce (~25 MB at 28 x 1024 bins).
//
// Design: one cooperative launch (grid from the occupancy API, every
// block resident), cooperative_groups grid syncs between the phases:
//  0. every block reads the split site (split_state.cuh);
//  1. one grid-stride pass over all rows: a row of the leaf decides its
//     side from the split feature's bin, right-going rows get lid = new,
//     and a warp ballot writes the smaller child's membership as a bit
//     mask [ceil(N / 32)] | sync. Membership is fixed here, once: the
//     histogram passes below read the mask, never a lid that another
//     block may be writing;
//  2. virtual blocks (row chunk, feature tile) walk their chunk in
//     256-row tiles: member rows are compacted in row order (ballot +
//     popc), their ghc staged in shared memory, and warp w owns
//     features w, w + 8, ... of the tile; __match_any_sync groups the
//     lanes that hit one bin and the lowest lane adds its peers in lane
//     order. Sums are float64 in shared memory, so a bin's sum depends
//     on the row order alone, and each chunk writes a float64 partial
//     | sync;
//  3. partials summed in chunk order in float64 and rounded once (as
//     the plain histogram, ops/histogram.py, accumulates in float64 and
//     rounds once); sibling = parent - child in float32; both cache rows
//     written | sync;
//  4. both children's scans (scan_core.cuh), one virtual block per
//     (child, feature), 256 threads walking up to 1024 bins | sync;
//  5. block 0: both S columns, the T column, k + 1 (split_state.cuh).
// No float atomics: the result is bitwise reproducible on one card (the
// chunking follows the grid, so another card may round differently).
// Compiled with -fmad=false: the scan, the leaf outputs and the
// subtraction follow the plain version's float32 expression order.
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
constexpr int kTileRows = kThreads;

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
  double* partial;  // [nchunks, F, B, 3]
  unsigned* mask;   // [ceil(N / 32)] smaller-child membership bits
  float* table;     // [2, F, 8] scan tables of the two children
  int n, big_l, F, B, feat_tile, nchunks, has_mono, nf, si0, max_depth;
  ltt::Params p;
};

template <typename BinT, int kCap>
__global__ void __launch_bounds__(kThreads, 2)
split_step_leaf_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  double* hist_s = reinterpret_cast<double*>(dyn);
  __shared__ ltt::Site site;
  __shared__ int iscratch[33];
  __shared__ float fscratch[kWarps];
  __shared__ int row_s[kTileRows];
  __shared__ float g_s[kTileRows], h_s[kTileRows], c_s[kTileRows];
  __shared__ int wcnt[kWarps];
  cg::grid_group grid = cg::this_grid();
  const BinT* bins = static_cast<const BinT*>(a.bins);

  // ---- 0. the split site ---------------------------------------------
  ltt::read_site(a, site, fscratch, iscratch);
  if (!site.go) return;  // every block decides alike: no barrier skipped
  const int F = a.F, B = a.B;
  const int* im = a.imeta + site.feat * ltt::IM_COLS;
  const ltt::Decision d{site.feat, site.thr, site.dleft, im[ltt::IM_MISS],
                        im[ltt::IM_DEFBIN], im[ltt::IM_NBINS], 0, nullptr};
  const ltt::Pair q = ltt::derive_pair(a, site);
  const int leaf = site.leaf, nw = site.k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = a.n;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;

  // ---- 1. leaf_id update and the smaller child's membership mask -----
  // gsize and each warp's first row are multiples of 32, so a warp's
  // lanes walk one mask word together
  const long long n32 = (n + 31) & ~31LL;
  for (long long r = gtid; r < n32; r += gsize) {
    bool member = false;
    if (r < n && a.lid[r] == leaf) {
      const bool left =
          ltt::go_left((int)bins[(size_t)r * F + site.feat], d);
      if (!left) a.lid[r] = nw;
      member = left == q.small_left;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, member);
    if (lane == 0) a.mask[r >> 5] = bal;
  }
  grid.sync();

  // ---- 2. the smaller child's histogram, per (chunk, feature tile) ---
  const int nft = (F + a.feat_tile - 1) / a.feat_tile;
  const long long chunk =
      ((n + a.nchunks - 1) / a.nchunks + kTileRows - 1) / kTileRows *
      kTileRows;
  for (int v = blockIdx.x; v < a.nchunks * nft; v += gridDim.x) {
    const int c = v / nft, f0 = (v % nft) * a.feat_tile;
    const int nf = min(a.feat_tile, F - f0);
    const int n3 = nf * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads) hist_s[i] = 0.0;
    const long long r0 = min(n, (long long)c * chunk);
    const long long r1 = min(n, r0 + chunk);
    __syncthreads();
    for (long long t0 = r0; t0 < r1; t0 += kTileRows) {
      const long long r = t0 + threadIdx.x;
      const bool member = r < r1 && ((a.mask[r >> 5] >> lane) & 1u);
      const unsigned bal = __ballot_sync(0xffffffffu, member);
      if (lane == 0) wcnt[warp] = __popc(bal);
      __syncthreads();
      int before = 0, m = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? wcnt[w] : 0;
        m += wcnt[w];
      }
      if (m > 0) {  // m is the same in every thread
        if (member) {
          const int pos = before + __popc(bal & ((1u << lane) - 1u));
          row_s[pos] = threadIdx.x;
          g_s[pos] = a.ghc[r * 3 + 0];
          h_s[pos] = a.ghc[r * 3 + 1];
          c_s[pos] = a.ghc[r * 3 + 2];
        }
        __syncthreads();
        // the tile's address as one product (see hist_tile.cuh)
        const BinT* tile = bins + (size_t)t0 * F;
        for (int fl = warp; fl < nf; fl += kWarps) {
          double* hf = hist_s + (size_t)fl * B * 3;
          const BinT* col = tile + f0 + fl;
          for (int base = 0; base < m; base += 32) {
            const int j = base + lane;
            const bool valid = j < m;
            const int bin = valid ? (int)col[(size_t)row_s[j] * F] : -1;
            const unsigned peers = __match_any_sync(0xffffffffu, bin);
            if (valid && lane == __ffs(peers) - 1) {
              double sg = 0.0, sh = 0.0, sc = 0.0;
              unsigned mm = peers;
              while (mm) {
                const int p = base + __ffs(mm) - 1;
                mm &= mm - 1;
                sg += (double)g_s[p];
                sh += (double)h_s[p];
                sc += (double)c_s[p];
              }
              hf[bin * 3 + 0] += sg;
              hf[bin * 3 + 1] += sh;
              hf[bin * 3 + 2] += sc;
            }
          }
        }
      }
      __syncthreads();  // wcnt, row_s and the staged ghc are reused
    }
    double* dst = a.partial + ((size_t)c * F + f0) * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads) dst[i] = hist_s[i];
    __syncthreads();
  }
  grid.sync();

  // ---- 3. child = partials in chunk order, rounded once; sibling ------
  const int idx_a = q.small_left ? leaf : nw;
  const int idx_b = q.small_left ? nw : leaf;
  {
    const long long n3 = (long long)F * B * 3;
    for (long long i = gtid; i < n3; i += gsize) {
      double s = a.partial[i];
      for (int c = 1; c < a.nchunks; ++c) s += a.partial[(size_t)c * n3 + i];
      const float child = (float)s;
      const float parent = a.hist[(size_t)leaf * n3 + i];
      a.hist[(size_t)idx_a * n3 + i] = child;
      a.hist[(size_t)idx_b * n3 + i] = parent - child;
    }
  }
  grid.sync();

  // ---- 4. both children's scans (the planes reuse the histogram's
  // shared memory, free after the sync above) --------------------------
  auto& scan_sm = *reinterpret_cast<ltt::ScanSmem<kCap>*>(dyn);
  for (int v = blockIdx.x; v < 2 * F; v += gridDim.x) {
    const int c = v / F, f = v % F;
    const float* h = a.hist + ((size_t)(c == 0 ? idx_a : idx_b) * F + f) *
                                  B * 3;
    const int* mf = a.imeta + f * ltt::IM_COLS;
    ltt::scan_feature<kCap>(h, B, c == 0 ? q.a : q.b, mf[ltt::IM_NBINS],
                            mf[ltt::IM_MISS], mf[ltt::IM_DEFBIN],
                            mf[ltt::IM_MONO], a.fmeta[f * 2 + 0],
                            a.fmeta[f * 2 + 1], a.p, scan_sm,
                            a.table + ((size_t)c * F + f) * 8);
  }
  grid.sync();

  // ---- 5. state, tree arrays, k ---------------------------------------
  if (blockIdx.x == 0 && threadIdx.x == 0)
    ltt::finish(a, site, q, 0, 0, 0, 0);
}

size_t leaf_smem_bytes(int B, int feat_tile, size_t scan_bytes) {
  const size_t hist = (size_t)feat_tile * B * 3 * sizeof(double);
  return hist > scan_bytes ? hist : scan_bytes;
}

// Launch shape of one instance: blocks per SM and grid, cached per
// (device, shared-memory size).
template <typename BinT, int kCap>
int leaf_grid(size_t smem, int* per_sm_out, int* grid_out) {
  static int dev_c = -1, per_sm_c = 0, grid_c = 0;
  static size_t smem_c = 0;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != dev_c || smem != smem_c) {
    const int err = ltt::cooperative_grid(split_step_leaf_kernel<BinT, kCap>,
                                          kThreads, smem, &per_sm_c, &grid_c);
    if (err) return err;
    dev_c = dev;
    smem_c = smem;
  }
  *per_sm_out = per_sm_c;
  *grid_out = grid_c;
  return 0;
}

// grid, shared memory and row chunks of one launch: one virtual block
// per (chunk, feature tile) fills the grid once
int leaf_shape(int bin_bytes, int n, int F, int B, int feat_tile,
               int* out) {
  if (B < 1 || F < 1 || feat_tile < 1 || n < 1 ||
      (bin_bytes == 1 && B > ltt::kMaxBins) ||
      (bin_bytes == 2 && B > ltt::kMaxScanBins) ||
      (bin_bytes != 1 && bin_bytes != 2))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  int err;
  if (bin_bytes == 1) {
    smem = leaf_smem_bytes(B, feat_tile,
                           sizeof(ltt::ScanSmem<ltt::kMaxBins>));
    err = leaf_grid<uint8_t, ltt::kMaxBins>(smem, &out[0], &out[1]);
  } else {
    smem = leaf_smem_bytes(B, feat_tile,
                           sizeof(ltt::ScanSmem<ltt::kMaxScanBins>));
    err = leaf_grid<uint16_t, ltt::kMaxScanBins>(smem, &out[0], &out[1]);
  }
  out[2] = (int)smem;
  const int nft = (F + feat_tile - 1) / feat_tile;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int chunks = out[1] / nft;
  out[3] = chunks < 1 ? 1 : (chunks > tiles ? tiles : chunks);
  return err;
}

}  // namespace

// The launch shape of the leaf step: out[0] blocks per SM, out[1] grid
// size, out[2] dynamic shared-memory bytes per block, out[3] row chunks
// (the leading dimension of the partials).
LTT_EXPORT int ltt_split_step_leaf_shape(int bin_bytes, int n, int F, int B,
                                         int feat_tile, int* out) {
  return leaf_shape(bin_bytes, n, F, B, feat_tile, out);
}

// k: device int32[1]; S [nf + 7, L], T [9, L - 1] f32; lid int32[n];
// hist [L, F, B, 3] f32; bins [n, F] u8 (bin_bytes 1) or u16 (2); ghc
// [n, 3] f32; imeta [F, 8] i32, fmeta [F, 2] f32; partial
// [nchunks, F, B, 3] f64, mask u32[ceil(n / 32)], table [2, F, 8] f32.
LTT_EXPORT int ltt_split_step_leaf(
    int bin_bytes, int* k, float* S, float* T, int* lid, float* hist,
    const void* bins, const float* ghc, const int* imeta, const float* fmeta,
    double* partial, unsigned* mask, float* table, int n, int big_l, int F,
    int B, int feat_tile, int nchunks, int has_mono, int max_depth, float l1,
    float l2, float mds, float min_data, float min_hess, float min_gain,
    cudaStream_t stream) {
  int shape[4];
  const int err = leaf_shape(bin_bytes, n, F, B, feat_tile, shape);
  if (err) return err;
  if (big_l < 2 || nchunks != shape[3]) return (int)cudaErrorInvalidValue;
  Args a{k,       S,     T,       lid,     hist,    bins,
         ghc,     imeta, fmeta,   partial, mask,    table,
         n,       big_l, F,       B,       feat_tile, nchunks,
         has_mono, has_mono ? 12 : 10, 0, max_depth,
         ltt::Params{l1, l2, mds, min_data, min_hess, min_gain}};
  void* params[] = {&a};
  const void* fn =
      bin_bytes == 1
          ? (const void*)split_step_leaf_kernel<uint8_t, ltt::kMaxBins>
          : (const void*)split_step_leaf_kernel<uint16_t, ltt::kMaxScanBins>;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(shape[1]), dim3(kThreads), params, (size_t)shape[2], stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
