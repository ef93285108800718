// Device code of the stable segment partition. go_left, the decision,
// is shared by the per-phase kernel (partition_segment.cu) and both
// fused split steps, so they cannot drift apart.
//
// The segment fused step (split_step_segment.cu) partitions a segment
// too large to hold in registers through the workspace: a segment of
// `count` rows starting at matrix row `begin` is cut into 256-row tiles;
// per tile the left count (tile_left_count), then, from the tiles'
// exclusive offsets, a stable scatter of whole rows (tile_scatter):
// lefts to dst[0, NL), rights to dst[NL, count), each side in row order.
#pragma once

#include "common.cuh"

namespace ltt {

constexpr int kPartRows = 256;  // rows per tile = threads per block

struct Decision {
  int feat, thr, dleft, miss, defbin, nbins, use_lut;
  const float* lut;
};

// rows_go_left of lightgbm_tpu_torch/ops/partition.py: numerical
// threshold with missing codes none/zero/nan, or a 256-entry LUT.
__device__ __forceinline__ bool go_left(int b, const Decision& d) {
  if (d.use_lut) return d.lut[b] > 0.5f;
  const bool is_missing = (d.miss == LTT_MISSING_ZERO && b == d.defbin) ||
                          (d.miss == LTT_MISSING_NAN && b == d.nbins - 1);
  return is_missing ? d.dleft != 0 : b <= d.thr;
}

// Left count of tile `tile`; every thread of a 256-thread block calls it
// and gets the count.
__device__ __forceinline__ int tile_left_count(const uint8_t* mat, int stride,
                                               long long begin,
                                               long long count, int tile,
                                               const Decision& d) {
  const long long r = (long long)tile * kPartRows + threadIdx.x;
  int left = 0;
  if (r < count)
    left = go_left(mat[(size_t)(begin + r) * stride + d.feat], d) ? 1 : 0;
  return __syncthreads_count(left);
}

// Stable scatter of tile `tile` to dst rows (segment-relative): in-tile
// ranks from warp ballots + popc and a scan over the block's 8 warp
// counts; lefts land at lefts_before + rank, rights at
// nl + rights_before + rank. Each warp copies its 32 rows as 16-byte
// vectors, neighbouring lanes on neighbouring source addresses.
// wlr: shared int[16].
__device__ __forceinline__ void tile_scatter(const uint8_t* mat, uint8_t* dst,
                                             int stride, long long begin,
                                             long long count, int tile,
                                             const Decision& d,
                                             int lefts_before, int nl,
                                             int* wlr) {
  int* wl = wlr;
  int* wr = wlr + kPartRows / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = (long long)tile * kPartRows;
  const long long r = row0 + threadIdx.x;
  const bool valid = r < count;
  const bool left =
      valid && go_left(mat[(size_t)(begin + r) * stride + d.feat], d);
  const bool right = valid && !left;
  const unsigned bl = __ballot_sync(0xffffffffu, left);
  const unsigned br = __ballot_sync(0xffffffffu, right);
  if (lane == 0) {
    wl[warp] = __popc(bl);
    wr[warp] = __popc(br);
  }
  __syncthreads();
  int off_l = 0, off_r = 0;
  for (int w = 0; w < warp; ++w) {
    off_l += wl[w];
    off_r += wr[w];
  }
  const unsigned lt = (1u << lane) - 1u;
  const int rights_before = (int)row0 - lefts_before;
  long long dest = -1;
  if (left) dest = lefts_before + off_l + __popc(bl & lt);
  if (right) dest = (long long)nl + rights_before + off_r + __popc(br & lt);

  const int vpr = stride / 16;  // 16-byte vectors per row
  const int4* src = reinterpret_cast<const int4*>(
      mat + (size_t)(begin + row0 + warp * 32) * stride);
  int4* dv = reinterpret_cast<int4*>(dst);
  for (int k = lane; k < 32 * vpr; k += 32) {
    const int rr = k / vpr;
    const long long dr = __shfl_sync(0xffffffffu, dest, rr);
    if (dr >= 0) dv[(size_t)dr * vpr + (k - rr * vpr)] = src[k];
  }
  __syncthreads();  // wl/wr are reused by the block's next tile
}

}  // namespace ltt
