// Numerical best-split scan of one or two leaves on Hopper.
//
// Replaces the TPU kernel _scan_kernel / scan_core via
// per_feature_numerical_pallas (lightgbm_tpu/ops/split_scan_pallas.py:56,
// :70, :342), which the JAX grow loop vmaps over both fresh children
// (lightgbm_tpu/learner/split_step.py:485). Here both children are one
// launch: grid (K, F), one block a (leaf, feature) row, of a block size
// picked from B (scan_threads; the winner does not depend on it:
// scan_core.cuh). Like the TPU kernel it takes B from the
// histogram's shape, 1 <= B <= 65,536: up to 256 bins the planes take
// 7 KB of static shared memory (split_scan_kernel<kMaxBins>), up to 1024
// 26 KB (split_scan_kernel<kMaxScanBins>), with the same device code;
// past 1024 bins split_scan_wide_kernel walks the bins in windows of
// 1024 through the same 26 KB (scan_core.cuh scan_feature_wide: two
// passes, the prefix sums carried in float64 from window to window).
//
// The per-feature scan is scan_feature (scan_core.cuh, shared with the
// fused split steps): both missing-value directions, L1/L2/
// max_delta_step, min_data/min_hessian, monotone bounds, the feature
// mask and penalty, the reference's tie rules. The arithmetic follows
// lightgbm_tpu_torch/ops/split.py (per_feature_numerical, its plain
// version) expression by expression; this file is compiled with
// -fmad=false so no multiply-add contraction changes a rounding.
//
// With extra_trees or by-node feature sampling the grow loop passes a node
// table (ltt_split_scan's node0/node1, one [F] int32 row a leaf, rows of
// the tree's [2L + 1, F] table picked by each child's salt): bits 0-15 hold
// the feature's rand bin as a uint16 (0xffff: every threshold; a rand
// bin is a threshold, at most 65,534), bit 16 the
// node mask (0: the feature is out of this node's sample, as if fmask were
// 0). Without a table (null rows, and always in the fused steps) the scan
// is unchanged.
//
// What bounds it on the H100: not memory (one leaf pair is 2 * F * B * 3
// floats in and 2 * F * 8 out, ~0.7 MB at F = 28, B = 1024: 0.21 us at
// 3.35 TB/s) but a launch's minimum device time (~2 us) and, inside a
// block, the chain of one scan: the plane loads, 32 dependent float64
// adds a segment and a warp scan, the candidates of a thread's bins,
// two block barriers and the key reductions. scan_core.cuh keeps that
// chain short.
#include "common.cuh"
#include "scan_core.cuh"

namespace {

using ltt::kMaxBins;
using ltt::kMaxScanBins;
using ltt::kMaxWideBins;
using ltt::kScanWindow;
// the most threads a block: a prefix lane keeps 32 float64 running sums
// in registers, so 128 registers a thread, not the 64 of 1024 threads
constexpr int kMaxThreads = 512;

// Threads a block at B bins, by measurement (chip_profile.py
// --scan-phases, which sweeps the block size through
// ltt_split_scan_profile): 256 up to 256 bins, 512 above (at 1023 bins
// 384 and 512 are within 0.1 us, 256 and fewer slower).
inline int scan_threads(int B) { return B <= kMaxBins ? 256 : kMaxThreads; }
// the wide scan's warp c owns plane c: at least six warps
constexpr int kMinWideThreads = 192;

struct ScanArgs {
  int num_bins;
  const float* hist0;
  const float* hist1;
  ltt::Leaf leaf0, leaf1;
  const int* imeta;
  const float* fmeta;
  const int* node0;  // node table rows (null: no table)
  const int* node1;
  ltt::Params p;
  float* out;
  unsigned long long* times;  // timed instantiation: [K, F, 5] clock64
};

// This block's (leaf, feature) row: its histogram, leaf, rand bin and
// feature mask (from the node table when there is one).
struct Row {
  const float* hist;
  ltt::Leaf L;
  const int* im;
  size_t row;
  int rand_bin;
  float fmask;
};

__device__ __forceinline__ Row block_row(const ScanArgs& a) {
  const int k = blockIdx.x, f = blockIdx.y;
  Row r;
  r.L = k == 0 ? a.leaf0 : a.leaf1;
  r.hist = (k == 0 ? a.hist0 : a.hist1) + (size_t)f * a.num_bins * 3;
  r.im = a.imeta + f * 4;
  r.row = (size_t)k * gridDim.y + f;
  const int* node = k == 0 ? a.node0 : a.node1;
  r.rand_bin = -1;
  r.fmask = a.fmeta[f * 2 + 1];
  if (node != nullptr) {
    const int v = node[f];
    const int rb = v & 0xffff;
    r.rand_bin = rb == 0xffff ? -1 : rb;
    if (!((v >> 16) & 1)) r.fmask = 0.f;
  }
  return r;
}

template <int kCap, bool kClock>
__global__ void __launch_bounds__(kMaxThreads) split_scan_kernel(ScanArgs a) {
  __shared__ ltt::ScanSmem<kCap> sm;
  const Row r = block_row(a);
  // a block of its own: the running sums stay in registers
  ltt::scan_feature<kCap, kClock, true>(
      r.hist, a.num_bins, r.L, r.im[0], r.im[1], r.im[2], r.im[3],
      a.fmeta[blockIdx.y * 2 + 0], r.fmask, a.p, sm, a.out + r.row * 8,
      kClock ? a.times + r.row * 5 : nullptr, r.rand_bin);
}

template <bool kClock>
__global__ void __launch_bounds__(kMaxThreads)
    split_scan_wide_kernel(ScanArgs a) {
  __shared__ ltt::ScanSmem<kScanWindow> sm;
  const Row r = block_row(a);
  ltt::scan_feature_wide<kClock>(
      r.hist, a.num_bins, r.L, r.im[0], r.im[1], r.im[2], r.im[3],
      a.fmeta[blockIdx.y * 2 + 0], r.fmask, a.p, sm, a.out + r.row * 8,
      kClock ? a.times + r.row * 5 : nullptr, r.rand_bin);
}

template <bool kClock>
int launch_scan(int K, int F, int B, int threads, const ScanArgs& a,
                cudaStream_t stream) {
  if (B < 1 || B > kMaxWideBins || K < 1 || K > 2 || F < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      (B > kMaxScanBins && threads < kMinWideThreads))
    return (int)cudaErrorInvalidValue;
  if (B <= kMaxBins)
    split_scan_kernel<kMaxBins, kClock>
        <<<dim3(K, F), threads, 0, stream>>>(a);
  else if (B <= kMaxScanBins)
    split_scan_kernel<kMaxScanBins, kClock>
        <<<dim3(K, F), threads, 0, stream>>>(a);
  else
    split_scan_wide_kernel<kClock><<<dim3(K, F), threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K leaves (1 or 2) x F features; hist{0,1}: [F, B, 3] f32; imeta
// [F, 4] i32 (num_bins, missing, default_bin, monotone); fmeta [F, 2]
// f32 (penalty, numerical-and-in-mask); node0/node1 the leaves' node
// table rows ([F] i32 each, or null); out [K, F, 8] f32.
LTT_EXPORT int ltt_split_scan(int K, int F, int B, const float* hist0,
                              const float* hist1, float pg0, float ph0,
                              float pc0, float cmin0, float cmax0, float pg1,
                              float ph1, float pc1, float cmin1, float cmax1,
                              const int* imeta, const float* fmeta, float l1,
                              float l2, float mds, float min_data,
                              float min_hess, float min_gain,
                              const int* node0, const int* node1, float* out,
                              cudaStream_t stream) {
  const ScanArgs a{B,
                   hist0,
                   hist1,
                   ltt::Leaf{pg0, ph0, pc0, cmin0, cmax0},
                   ltt::Leaf{pg1, ph1, pc1, cmin1, cmax1},
                   imeta,
                   fmeta,
                   node0,
                   node1,
                   ltt::Params{l1, l2, mds, min_data, min_hess, min_gain},
                   out,
                   nullptr};
  return launch_scan<false>(K, F, B, scan_threads(B), a, stream);
}

// For profiling only (chip_profile.py, the card tests): the same table
// at a block size the caller picks (a multiple of 32 in [32, 512], at
// least 192 past 1024 bins; 0: scan_threads(B)) and, when times is not
// null, from the timed instantiation: thread 0 of block (k, f) writes
// scan_feature's five clock64 reads to times[k, f, 0:5] (u64).
LTT_EXPORT int ltt_split_scan_profile(
    int K, int F, int B, const float* hist0, const float* hist1, float pg0,
    float ph0, float pc0, float cmin0, float cmax0, float pg1, float ph1,
    float pc1, float cmin1, float cmax1, const int* imeta,
    const float* fmeta, float l1, float l2, float mds, float min_data,
    float min_hess, float min_gain, int threads, float* out,
    unsigned long long* times, cudaStream_t stream) {
  const ScanArgs a{B,
                   hist0,
                   hist1,
                   ltt::Leaf{pg0, ph0, pc0, cmin0, cmax0},
                   ltt::Leaf{pg1, ph1, pc1, cmin1, cmax1},
                   imeta,
                   fmeta,
                   nullptr,
                   nullptr,
                   ltt::Params{l1, l2, mds, min_data, min_hess, min_gain},
                   out,
                   times};
  if (threads == 0) threads = scan_threads(B);
  return times ? launch_scan<true>(K, F, B, threads, a, stream)
               : launch_scan<false>(K, F, B, threads, a, stream);
}
