// Numerical best-split scan of one or two leaves on Hopper.
//
// Replaces the TPU kernel _scan_kernel / scan_core via
// per_feature_numerical_pallas (lightgbm_tpu/ops/split_scan_pallas.py:56,
// :70, :342), which the JAX grow loop vmaps over both fresh children
// (lightgbm_tpu/learner/split_step.py:485). Here both children are one
// launch: grid (K, F), block = one thread per bin. Like the TPU kernel
// it takes B from the histogram's shape, 1 <= B <= 1024: up to 256 bins
// the planes are static shared memory (split_scan_kernel), above that
// dynamic (split_scan_kernel_wide), with the same device code.
//
// The per-feature scan is scan_feature (scan_core.cuh, shared with the
// fused split steps): both missing-value directions, L1/L2/
// max_delta_step, min_data/min_hessian, monotone bounds, the feature
// mask and penalty, the reference's tie rules. The arithmetic follows
// lightgbm_tpu_torch/ops/split.py (per_feature_numerical, its plain
// version) expression by expression; this file is compiled with
// -fmad=false so no multiply-add contraction changes a rounding.
//
// What bounds it on the H100: launch latency at 256 bins (one leaf pair
// is 2 * F * B * 3 floats in and 2 * F * 8 out, ~170 KB at F=28, well
// under a microsecond of memory time); at 1024 bins the six sequential
// prefix sums of 1024 bins per block.
#include "common.cuh"
#include "scan_core.cuh"

namespace {

using ltt::kMaxBins;
using ltt::kMaxScanBins;

struct ScanArgs {
  int num_bins;
  const float* hist0;
  const float* hist1;
  ltt::Leaf leaf0, leaf1;
  const int* imeta;
  const float* fmeta;
  ltt::Params p;
  float* out;
};

template <int kCap>
__device__ __forceinline__ void scan_block(const ScanArgs& a,
                                           ltt::ScanSmem<kCap>& sm) {
  const int k = blockIdx.x, f = blockIdx.y;
  const int B = a.num_bins;
  const ltt::Leaf L = k == 0 ? a.leaf0 : a.leaf1;
  const float* hist = (k == 0 ? a.hist0 : a.hist1) + (size_t)f * B * 3;
  const int* im = a.imeta + f * 4;
  ltt::scan_feature<kCap>(hist, B, L, im[0], im[1], im[2], im[3],
                          a.fmeta[f * 2 + 0], a.fmeta[f * 2 + 1], a.p, sm,
                          a.out + ((size_t)k * gridDim.y + f) * 8);
}

__global__ void __launch_bounds__(kMaxBins)
split_scan_kernel(ScanArgs a) {
  __shared__ ltt::ScanSmem<kMaxBins> sm;
  scan_block<kMaxBins>(a, sm);
}

__global__ void __launch_bounds__(kMaxScanBins)
split_scan_kernel_wide(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  scan_block<kMaxScanBins>(
      a, *reinterpret_cast<ltt::ScanSmem<kMaxScanBins>*>(dyn));
}

}  // namespace

// K leaves (1 or 2) x F features; hist{0,1}: [F, B, 3] f32; imeta
// [F, 4] i32 (num_bins, missing, default_bin, monotone); fmeta [F, 2]
// f32 (penalty, numerical-and-in-mask); out [K, F, 8] f32.
LTT_EXPORT int ltt_split_scan(int K, int F, int B, const float* hist0,
                              const float* hist1, float pg0, float ph0,
                              float pc0, float cmin0, float cmax0, float pg1,
                              float ph1, float pc1, float cmin1, float cmax1,
                              const int* imeta, const float* fmeta, float l1,
                              float l2, float mds, float min_data,
                              float min_hess, float min_gain, float* out,
                              cudaStream_t stream) {
  if (B < 1 || B > kMaxScanBins || K < 1 || K > 2)
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{B,
                   hist0,
                   hist1,
                   ltt::Leaf{pg0, ph0, pc0, cmin0, cmax0},
                   ltt::Leaf{pg1, ph1, pc1, cmin1, cmax1},
                   imeta,
                   fmeta,
                   ltt::Params{l1, l2, mds, min_data, min_hess, min_gain},
                   out};
  const int threads = (B + 31) / 32 * 32;
  if (B <= kMaxBins) {
    split_scan_kernel<<<dim3(K, F), threads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int smem = (int)sizeof(ltt::ScanSmem<kMaxScanBins>);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_scan_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  split_scan_kernel_wide<<<dim3(K, F), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
