// Segment histogram on Hopper.
//
// Replaces the TPU kernel _hist_nibble_kernel_grouped
// (lightgbm_tpu/ops/hist_pallas.py:322, via histogram_segment :617) and,
// since they compute the same function, its "perfeat" (:420) and
// "perbin" (:233) variants. Computes the [F, B, 3] (sum grad, sum hess,
// count) histogram of rows [begin, begin + count) of the u8 training
// matrix, decoding grad/hess from each row's payload bytes.
//
// What bounds it on the H100: the segment's bytes are read once
// (count * stride, 3.35 TB/s) -- but the scatter into 256 bins per
// feature is the real cost: per row and feature one bin lookup and one
// read-modify-write of a shared-memory bin.
//
// Design (simple and deterministic first; wgmma/TMA come later):
//  * The segment begins anywhere (no 8-row alignment: that was a Mosaic
//    DMA granule). Its rows are cut into gridDim.x contiguous chunks,
//    one per block; grid.y tiles the features when F*B*3 floats do not
//    fit the block's shared memory.
//  * A block walks its chunk with hist_rows (hist_tile.cuh, shared with
//    the fused split step): 256-row tiles, warps owning disjoint
//    features, __match_any_sync + lane-ordered sums, so the summation
//    order of every bin is fixed by the row order alone.
//  * Each block writes its partial histogram to scratch
//    [blocks, F, B, 3]; a second kernel sums the partials in block
//    order. No float atomics anywhere: the result is bitwise
//    reproducible from run to run.
//  * True float32 grad/hess sums; the TPU kernel's bf16 hi/lo split
//    (about 16 mantissa bits) is a TPU means, not part of the contract.
#include "common.cuh"
#include "hist_tile.cuh"

namespace {

constexpr int kThreads = ltt::kHistThreads;

__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const uint8_t* __restrict__ mat, int stride, int pay_off,
                    const int* __restrict__ seg, int num_features,
                    int num_bins, int feat_tile, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int f0 = blockIdx.y * feat_tile;
  const int nf = min(feat_tile, num_features - f0);
  float* hist_s = smem;                                 // [nf][B][3]
  float* stage = smem + (size_t)feat_tile * num_bins * 3;

  const int n3 = nf * num_bins * 3;
  for (int i = threadIdx.x; i < n3; i += kThreads) hist_s[i] = 0.f;

  const long long begin = seg[0];
  const long long count = seg[1];
  const long long chunk = (count + gridDim.x - 1) / gridDim.x;
  const long long r0 = min(count, (long long)blockIdx.x * chunk);
  const long long r1 = min(count, r0 + chunk);
  __syncthreads();
  ltt::hist_rows<true>(mat, begin, stride, pay_off, r0, r1, f0, nf,
                       num_bins, hist_s, stage);
  float* dst = out + ((size_t)blockIdx.x * num_features + f0) * num_bins * 3;
  for (int i = threadIdx.x; i < n3; i += kThreads) dst[i] = hist_s[i];
}

// out[i] = sum over blocks b, in block order, of partial[b][i]
__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   int nblk, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = partial[i];
  for (int b = 1; b < nblk; ++b) s += partial[(size_t)b * n + i];
  out[i] = s;
}

}  // namespace

// seg: device int32[2] = {begin, count}. nblk row chunks; partial holds
// [nblk, F, B, 3] floats when nblk > 1 (unused otherwise).
LTT_EXPORT int ltt_hist_segment(const uint8_t* mat, int stride, int pay_off,
                                const int* seg, int num_features,
                                int num_bins, int nblk, int feat_tile,
                                float* partial, float* out,
                                cudaStream_t stream) {
  const size_t smem =
      ltt::hist_smem_floats(feat_tile, num_bins) * sizeof(float);
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(nblk, (num_features + feat_tile - 1) / feat_tile);
  float* dst = nblk == 1 ? out : partial;
  hist_partial_kernel<<<grid, kThreads, smem, stream>>>(
      mat, stride, pay_off, seg, num_features, num_bins, feat_tile, dst);
  if (nblk > 1) {
    const int n = num_features * num_bins * 3;
    hist_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, nblk,
                                                            n, out);
  }
  return (int)cudaGetLastError();
}
