// Stable in-place partition of a row segment on Hopper.
//
// Replaces the TPU kernel _partition_kernel via partition_segment
// (lightgbm_tpu/ops/partition_pallas.py:51, :196). Rows
// [begin, begin + count) of the training matrix are reordered so the
// rows that go left come first, each side in its original order; whole
// rows move (bins, grad/hess payload, row id). The decision is
// rows_go_left's (lightgbm_tpu_torch/ops/partition.py): a numerical
// threshold with missing codes none/zero/nan, default_left, default bin
// and bin count, or a 256-entry LUT for categorical / bundled splits.
//
// What bounds it on the H100: memory traffic. A stable partition needs
// the segment read once and written once, 2 * count * stride bytes at
// 3.35 TB/s; this kernel moves twice that (scatter to the workspace,
// copy back).
//
// Design: a block-scan stable compaction instead of the TPU's
// permutation matmuls; the device code is partition_core.cuh, shared
// with the fused split step.
//  1. part_count: one thread per row decides left/right from the split
//     feature's byte; __syncthreads_count gives each 256-row block its
//     left count.
//  2. part_scan: one block turns the block counts into exclusive
//     offsets and writes {begin, NL, begin + NL, count - NL}.
//  3. part_scatter: in-block stable ranks from warp ballots + popc and a
//     scan over the block's 8 warp counts; lefts land at ws[rank],
//     rights at ws[NL + rank], as 16-byte vectors.
//  4. part_copy: ws[0, count) back to mat[begin, begin + count).
// NL stays on the device, so a caller never has to wait for it.
#include "common.cuh"
#include "partition_core.cuh"

namespace {

constexpr int kThreads = ltt::kPartRows;
using ltt::Decision;

__global__ void __launch_bounds__(kThreads)
part_count_kernel(const uint8_t* __restrict__ mat, int stride, int begin,
                  int count, Decision d, int* __restrict__ block_left) {
  const int total =
      ltt::tile_left_count(mat, stride, begin, count, blockIdx.x, d);
  if (threadIdx.x == 0) block_left[blockIdx.x] = total;
}

// single block of 1024 threads: exclusive scan of block_left in place
__global__ void __launch_bounds__(1024)
part_scan_kernel(int* __restrict__ block_left, int nblk, int begin,
                 int count, int* __restrict__ seg_out) {
  __shared__ int scratch[33];
  const int nl = ltt::block_exclusive_scan(block_left, nblk, scratch);
  if (threadIdx.x == 0) {
    seg_out[0] = begin;
    seg_out[1] = nl;
    seg_out[2] = begin + nl;
    seg_out[3] = count - nl;
  }
}

__global__ void __launch_bounds__(kThreads)
part_scatter_kernel(const uint8_t* __restrict__ mat, uint8_t* __restrict__ ws,
                    int stride, int begin, int count, Decision d,
                    const int* __restrict__ block_off,
                    const int* __restrict__ seg) {
  __shared__ int wlr[2 * kThreads / 32];
  ltt::tile_scatter(mat, ws, stride, begin, count, blockIdx.x, d,
                    block_off[blockIdx.x], seg[1], wlr);
}

__global__ void part_copy_kernel(const int4* __restrict__ src,
                                 int4* __restrict__ dst, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

}  // namespace

// block_buf: device int32[ceil(count / 256)] scratch;
// seg_out: device int32[4] = {begin, NL, begin + NL, count - NL}.
LTT_EXPORT int ltt_partition_segment(uint8_t* mat, uint8_t* ws, int stride,
                                     int begin, int count, int feat, int thr,
                                     int dleft, int miss, int defbin,
                                     int nbins, int use_lut, const float* lut,
                                     int* block_buf, int* seg_out,
                                     cudaStream_t stream) {
  const Decision d{feat, thr, dleft, miss, defbin, nbins, use_lut, lut};
  const int nblk = (count + kThreads - 1) / kThreads;
  if (nblk > 0)
    part_count_kernel<<<nblk, kThreads, 0, stream>>>(mat, stride, begin,
                                                     count, d, block_buf);
  part_scan_kernel<<<1, 1024, 0, stream>>>(block_buf, nblk, begin, count,
                                           seg_out);
  if (nblk > 0) {
    part_scatter_kernel<<<nblk, kThreads, 0, stream>>>(
        mat, ws, stride, begin, count, d, block_buf, seg_out);
    const long long nvec = (long long)count * (stride / 16);
    const int blocks = (int)min((nvec + 255) / 256, (long long)132 * 16);
    part_copy_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const int4*>(ws),
        reinterpret_cast<int4*>(mat + (size_t)begin * stride), nvec);
  }
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the Python side's exceptions.
LTT_EXPORT const char* ltt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
