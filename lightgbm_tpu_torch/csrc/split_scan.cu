// Numerical best-split scan of one or two leaves on Hopper.
//
// Replaces the TPU kernel _scan_kernel / scan_core via
// per_feature_numerical_pallas (lightgbm_tpu/ops/split_scan_pallas.py:56,
// :70, :342), which the JAX grow loop vmaps over both fresh children
// (lightgbm_tpu/learner/split_step.py:485). Here both children are one
// launch: grid (K, F), block = one thread per bin.
//
// The per-feature scan is scan_feature (scan_core.cuh, shared with the
// fused split step): both missing-value directions, L1/L2/
// max_delta_step, min_data/min_hessian, monotone bounds, the feature
// mask and penalty, the reference's tie rules. The arithmetic follows
// lightgbm_tpu_torch/ops/split.py (per_feature_numerical, its plain
// version) expression by expression; this file is compiled with
// -fmad=false so no multiply-add contraction changes a rounding.
//
// What bounds it on the H100: launch latency. One leaf pair is
// 2 * F * B * 3 floats in and 2 * F * 8 out (~170 KB at F=28, B=256),
// well under a microsecond of memory time.
#include "common.cuh"
#include "scan_core.cuh"

namespace {

using ltt::kMaxBins;

__global__ void __launch_bounds__(kMaxBins)
split_scan_kernel(int num_bins, const float* __restrict__ hist0,
                  const float* __restrict__ hist1, ltt::Leaf leaf0,
                  ltt::Leaf leaf1, const int* __restrict__ imeta,
                  const float* __restrict__ fmeta, ltt::Params p,
                  float* __restrict__ out) {
  __shared__ ltt::ScanSmem sm;
  const int k = blockIdx.x, f = blockIdx.y;
  const int B = num_bins;
  const ltt::Leaf L = k == 0 ? leaf0 : leaf1;
  const float* hist = (k == 0 ? hist0 : hist1) + (size_t)f * B * 3;
  ltt::scan_feature(hist, B, L, imeta[f * 4 + 0], imeta[f * 4 + 1],
                    imeta[f * 4 + 2], imeta[f * 4 + 3], fmeta[f * 2 + 0],
                    fmeta[f * 2 + 1], p, sm,
                    out + ((size_t)k * gridDim.y + f) * 8);
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
  if (B < 1 || B > kMaxBins || K < 1 || K > 2)
    return (int)cudaErrorInvalidValue;
  const ltt::Leaf a{pg0, ph0, pc0, cmin0, cmax0};
  const ltt::Leaf b{pg1, ph1, pc1, cmin1, cmax1};
  const ltt::Params p{l1, l2, mds, min_data, min_hess, min_gain};
  const int threads = (B + 31) / 32 * 32;
  split_scan_kernel<<<dim3(K, F), threads, 0, stream>>>(
      B, hist0, hist1, a, b, imeta, fmeta, p, out);
  return (int)cudaGetLastError();
}
