// Full-range histogram on Hopper: all rows of a bin matrix, or a list of
// row ids in row order.
//
// Replaces the TPU kernel histogram_pallas
// (lightgbm_tpu/ops/hist_pallas.py:642), the "pallas" method of
// build_histogram (lightgbm_tpu/ops/histogram.py:97-99), which builds
// the u8 training matrix on the fly and runs the segment histogram
// (histogram_segment :617, Pallas calls :569/:582/:305) over all of it.
// Computes the [F, B, 3] (sum grad, sum hess, count) f32 histogram of a
// row-major [N, F] bin matrix, u8 (B <= 256, all that the TPU function
// takes) or u16 (B <= 1024, the serial learner's bins held as int16
// bits), with ghc [N, 3] f32, over
//  * all N rows (the serial learner's root histogram), or
//  * the rows ids[0, count) in row order (a per-phase split's smaller
//    child: the rows whose ghc the JAX learner masks to zero add
//    nothing, so the list is the same function).
// No training matrix is built: the bins and ghc are read where they lie.
//
// What bounds it on the H100: bytes, in principle -- each listed row's
// ghc (12 B) and bins (F or 2F B) once, the id (4 B) in list mode: 80 MB
// at 2M x 28 u8, 136 MB at u16, ~0.024 / 0.041 ms at 3.35 TB/s. In
// practice the SM's work on each (row, feature) pair of the float64
// accumulation of hist_ids.cuh: finding a 32-row group's lanes of one
// bin, and the scattered read-modify-writes of the tile's bins in
// shared memory. The loop finds the lanes with integer atomics on a
// peer word a bin instead of __match_any_sync (hist_ids.cuh), with g
// and h one double2 and the count an integer.
//
// Design: the row loop of the leaf fused step (hist_ids.cuh), so a
// per-phase child's histogram equals the fused step's histogram of the
// same rows bit for bit. One launch of (chunk, feature tile) blocks, the
// chunks cut from count, F and the leaf kernel's feature tile alone
// (child_chunks, max_chunks_of), one block each, 256 threads; the tile
// and the shared memory are the leaf kernel's (the host passes
// leaf_feat_tile). A list of one chunk is rounded and written straight
// to out; otherwise each block writes its float64 partial and a second
// kernel sums the partials in chunk order and rounds once, as the fused
// step's reduce does. All-rows mode computes row = position and reads no
// list. No float atomics: bitwise reproducible, on any card. The count
// channel is counted, not summed: the rows whose count is not 0 (ghc's
// count is a 0/1 indicator, so the two are the same number).
//
// A second instantiation (kTimed, launched by chip_profile.py only) has
// thread 0 of every block record its clock64 laps of hist_chunk.
#include "common.cuh"
#include "hist_ids.cuh"

namespace {

using ltt::ids::kThreads;

template <typename BinT, bool kIds, bool kTimed>
__global__ void __launch_bounds__(kThreads)
hist_rows_kernel(const BinT* __restrict__ bins, const float* __restrict__ ghc,
                 const int* __restrict__ ids, long long count, int F, int B,
                 int feat_tile, int chunks, double* __restrict__ partial,
                 float* __restrict__ out, unsigned long long* times) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nft = ltt::ids::feature_tiles(F, feat_tile);
  const int c = blockIdx.x / nft, f0 = (blockIdx.x % nft) * feat_tile;
  const int nf = min(feat_tile, F - f0);
  const int n3 = nf * B * 3;
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const ltt::ids::TileSmem<BinT> tile =
      ltt::ids::carve<BinT>(dyn, feat_tile, B);
  ltt::ids::Laps<kTimed> clk;
  clk.start();
  ltt::ids::hist_chunk<BinT, kIds, kTimed, true>(ids, i0, i1, ghc, bins, F,
                                                 f0, nf, B, tile, clk);
  const size_t off = (size_t)f0 * B * 3;
  if (chunks == 1) {
    for (int i = threadIdx.x; i < n3; i += kThreads)
      out[off + i] = (float)ltt::ids::tile_value(tile, i);
  } else {
    double* dst = partial + (size_t)c * F * B * 3 + off;
    for (int i = threadIdx.x; i < n3; i += kThreads)
      dst[i] = ltt::ids::tile_value(tile, i);
  }
  if constexpr (kTimed) {
    clk.lap(3);
    if (threadIdx.x == 0)
      for (int i = 0; i < 4; ++i)
        times[(size_t)blockIdx.x * 4 + i] = clk.acc[i];
  }
}

// out[i] = the chunks' partials summed in chunk order, rounded once
__global__ void hist_rows_reduce(const double* __restrict__ partial,
                                 int chunks, long long n,
                                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = partial[i];
  for (int c = 1; c < chunks; ++c) s += partial[c * n + i];
  out[i] = (float)s;
}

template <typename BinT, bool kIds, bool kTimed>
int launch(const void* bins, const float* ghc, const int* ids,
           long long count, int F, int B, int feat_tile, int chunks,
           double* partial, float* out, unsigned long long* times,
           size_t smem, cudaStream_t stream) {
  // the attribute is set once per instance and size, not per launch
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_rows_kernel<BinT, kIds, kTimed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = chunks * ltt::ids::feature_tiles(F, feat_tile);
  hist_rows_kernel<BinT, kIds, kTimed><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), ghc, ids, count, F, B, feat_tile,
      chunks, partial, out, times);
  return (int)cudaGetLastError();
}

template <bool kTimed>
int hist_rows(int bin_bytes, const void* bins, const float* ghc,
              const int* ids, long long count, int F, int B, int feat_tile,
              int max_chunks, double* partial, float* out,
              unsigned long long* times, cudaStream_t stream) {
  if (F < 1 || B < 1 || count < 0 || feat_tile < 1 ||
      feat_tile > ltt::ids::kMaxTile ||
      (bin_bytes == 1 && B > 256) || (bin_bytes == 2 && B > 1024) ||
      (bin_bytes != 1 && bin_bytes != 2) ||
      max_chunks != ltt::ids::max_chunks_of(F, feat_tile) ||
      (kTimed && times == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = ltt::ids::child_chunks(count, max_chunks);
  if (chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = ltt::ids::tile_smem_bytes(bin_bytes, B, feat_tile);
  int err;
  if (bin_bytes == 1)
    err = ids ? launch<uint8_t, true, kTimed>(bins, ghc, ids, count, F, B,
                                              feat_tile, chunks, partial, out,
                                              times, smem, stream)
              : launch<uint8_t, false, kTimed>(bins, ghc, ids, count, F, B,
                                               feat_tile, chunks, partial,
                                               out, times, smem, stream);
  else
    err = ids ? launch<uint16_t, true, kTimed>(bins, ghc, ids, count, F, B,
                                               feat_tile, chunks, partial,
                                               out, times, smem, stream)
              : launch<uint16_t, false, kTimed>(bins, ghc, ids, count, F, B,
                                                feat_tile, chunks, partial,
                                                out, times, smem, stream);
  if (err || chunks == 1) return err;
  const long long n = (long long)F * B * 3;
  hist_rows_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, chunks, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// bins [n, F] u8 (bin_bytes 1) or u16 (2); ghc [n, 3] f32; ids: count
// int32 row ids in row order, or null for rows [0, count) (count = n);
// feat_tile: the leaf kernel's (leaf_feat_tile); max_chunks =
// max_chunks_of(F, feat_tile); partial [max_chunks, F, B, 3] f64 (used
// when the call takes more than one chunk); out [F, B, 3] f32.
LTT_EXPORT int ltt_hist_rows(int bin_bytes, const void* bins,
                             const float* ghc, const int* ids,
                             long long count, int F, int B, int feat_tile,
                             int max_chunks, double* partial, float* out,
                             cudaStream_t stream) {
  return hist_rows<false>(bin_bytes, bins, ghc, ids, count, F, B, feat_tile,
                          max_chunks, partial, out, nullptr, stream);
}

// The timed instantiation (chip_profile.py only): the same histogram,
// and thread 0 of every block writes its cycles into times (u64
// [grid, 4]: first fetch, stores, accumulation, write-out; the Laps of
// hist_ids.cuh hist_chunk).
LTT_EXPORT int ltt_hist_rows_timed(int bin_bytes, const void* bins,
                                   const float* ghc, const int* ids,
                                   long long count, int F, int B,
                                   int feat_tile, int max_chunks,
                                   double* partial, float* out,
                                   unsigned long long* times,
                                   cudaStream_t stream) {
  return hist_rows<true>(bin_bytes, bins, ghc, ids, count, F, B, feat_tile,
                         max_chunks, partial, out, times, stream);
}
