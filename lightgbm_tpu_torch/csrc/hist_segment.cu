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
// Design (deterministic; wgmma/TMA come later):
//  * The segment begins anywhere (no 8-row alignment: that was a Mosaic
//    DMA granule). Its rows are cut into row chunks by the chunk rule
//    of hist_tile.cuh, which the fused split step shares:
//    child_chunks(count, F) chunks, from the segment's row count and
//    the feature count alone. The count may live on the device (a child
//    the partition kernel produced): the grid is sized from the host's
//    upper bound on it, and the blocks past the segment's own chunks
//    exit. grid.y tiles the features, eight to a block.
//  * A block walks its chunk with hist_rows (hist_tile.cuh): 256-row
//    steps staged through registers into shared memory, the next step's
//    loads in flight while the current one is accumulated, warps owning
//    disjoint features, __match_any_sync + lane-ordered sums, so the
//    summation order of every bin is fixed by the row order alone.
//  * Sums are float64, rounded once to float32, as the plain version
//    accumulates. A segment of one chunk is rounded and written
//    straight to the output; else each chunk writes its float64
//    partial histogram to scratch [chunks, F, B, 3] and a second kernel
//    sums the partials in chunk order and rounds once. No float atomics
//    anywhere: the result is bitwise reproducible from run to run and
//    from card to card. The TPU kernel's bf16 hi/lo split (about 16
//    mantissa bits) is a TPU means, not part of the contract.
#include "common.cuh"
#include "hist_tile.cuh"

namespace {

constexpr int kThreads = ltt::kHistThreads;

__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const uint8_t* __restrict__ mat, int stride, int pay_off,
                    const int* __restrict__ seg, int num_features,
                    int num_bins, double* __restrict__ partial,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const long long begin = seg[0];
  const long long count = seg[1];
  const int chunks = ltt::child_chunks(count, num_features);
  if ((int)blockIdx.x >= chunks) return;  // past this segment's chunks
  const int f0 = blockIdx.y * ltt::kTileFeatures;
  const int nf = min(ltt::kTileFeatures, num_features - f0);
  double* hist_s = reinterpret_cast<double*>(dyn);  // [nf][B][3]
  unsigned char* stage = dyn + (size_t)ltt::kTileFeatures * num_bins * 24;

  const int n3 = nf * num_bins * 3;
  for (int i = threadIdx.x; i < n3; i += kThreads) hist_s[i] = 0.0;
  const long long chunk = (count + chunks - 1) / chunks;
  const long long r0 = min(count, (long long)blockIdx.x * chunk);
  const long long r1 = min(count, r0 + chunk);
  __syncthreads();
  ltt::hist_rows<false>(mat, begin, stride, pay_off, r0, r1, f0, nf,
                        num_bins, hist_s, stage);
  const size_t off = (size_t)f0 * num_bins * 3;
  if (chunks == 1) {
    for (int i = threadIdx.x; i < n3; i += kThreads)
      out[off + i] = (float)hist_s[i];
  } else {
    double* dst =
        partial + (size_t)blockIdx.x * num_features * num_bins * 3 + off;
    for (int i = threadIdx.x; i < n3; i += kThreads) dst[i] = hist_s[i];
  }
}

// out[i] = sum over the segment's chunks c, in chunk order, of
// partial[c][i], rounded once; nothing when the segment has one chunk
// (its block wrote out directly)
__global__ void hist_reduce_kernel(const double* __restrict__ partial,
                                   const int* __restrict__ seg,
                                   int num_features, int n,
                                   float* __restrict__ out) {
  const int chunks = ltt::child_chunks(seg[1], num_features);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (chunks == 1 || i >= n) return;
  double s = partial[i];
  for (int c = 1; c < chunks; ++c) s += partial[(size_t)c * n + i];
  out[i] = (float)s;
}

}  // namespace

// seg: device int32[2] = {begin, count}; max_chunks = child_chunks of
// an upper bound on count known to the host (the grid); partial holds
// [max_chunks, F, B, 3] doubles when max_chunks > 1 (unused otherwise).
LTT_EXPORT int ltt_hist_segment(const uint8_t* mat, int stride, int pay_off,
                                const int* seg, int num_features,
                                int num_bins, int max_chunks,
                                double* partial, float* out,
                                cudaStream_t stream) {
  if (num_features < 1 || num_bins < 1 || num_bins > 256 ||
      max_chunks < 1 || max_chunks > ltt::max_chunks(num_features) ||
      stride % 16 || pay_off % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ltt::hist_smem_bytes(num_bins);
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(max_chunks, ltt::feature_tiles(num_features));
  hist_partial_kernel<<<grid, kThreads, smem, stream>>>(
      mat, stride, pay_off, seg, num_features, num_bins, partial, out);
  if (max_chunks > 1) {
    const int n = num_features * num_bins * 3;
    hist_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        partial, seg, num_features, n, out);
  }
  return (int)cudaGetLastError();
}
