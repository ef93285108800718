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
// takes), u16 (B <= 32,768, the serial learner's bins held as int16
// bits) or u32 (B <= 65,536: past 32,768 bins the device copy is
// int32), with ghc [N, 3] f32, over
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
// Past 1024 bins the tile rule (leaf_feat_tile) gives one feature a
// tile from ~4,400 bins on, and its bins take more than the leaf
// kernel's 110 KB (one block an SM). Past the bins whose one-feature
// tile fits a block's 227 KB (~9,400), each block takes one window of
// a feature's bins (bin_window): blocks are (chunk, feature tile,
// window), each reads its chunk's rows and adds the rows of its window
// only. The chunks are cut as before (windows do not enter
// max_chunks_of), and a bin's float64 sum has the same adds in the same
// order whatever the windows.
//
// out64, when given, takes the float64 sums unrounded instead of the
// float32 out (the data-parallel learners reduce them across ranks
// before their one rounding).
//
// A second instantiation (kTimed, launched by chip_profile.py only) has
// thread 0 of every block record its clock64 laps of hist_chunk.
#include "common.cuh"
#include "hist_ids.cuh"

namespace {

using ltt::ids::kThreads;
// a block's dynamic shared memory, at most (the H100's 227 KB)
constexpr size_t kMaxSmem = 232448;

// The window of bins a block takes: all B bins when the tile fits
// kMaxSmem, else the most bins of one feature that do.
inline int bin_window(int bin_bytes, int B, int feat_tile) {
  if (ltt::ids::tile_smem_bytes(bin_bytes, B, feat_tile) <= kMaxSmem)
    return B;
  if (feat_tile != 1) return 0;
  const size_t fixed = ltt::ids::tile_smem_bytes(bin_bytes, 0, 1);
  return (int)((kMaxSmem - fixed) / ltt::ids::kBinBytes);
}

template <typename BinT, bool kIds, bool kTimed>
__global__ void __launch_bounds__(kThreads)
hist_rows_kernel(const BinT* __restrict__ bins, const float* __restrict__ ghc,
                 const int* __restrict__ ids, long long count, int F, int B,
                 int feat_tile, int chunks, int win,
                 double* __restrict__ partial, float* __restrict__ out,
                 double* __restrict__ out64, unsigned long long* times) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nft = ltt::ids::feature_tiles(F, feat_tile);
  const int nwin = (B + win - 1) / win;
  const int c = blockIdx.x / (nft * nwin);
  const int r = blockIdx.x % (nft * nwin);
  const int f0 = (r / nwin) * feat_tile, lo = (r % nwin) * win;
  const int nf = min(feat_tile, F - f0);
  const int nb = min(win, B - lo);  // this block's bins [lo, lo + nb)
  const int n3 = nf * nb * 3;
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const ltt::ids::TileSmem<BinT> tile =
      ltt::ids::carve<BinT>(dyn, feat_tile, win);
  ltt::ids::Laps<kTimed> clk;
  clk.start();
  ltt::ids::hist_chunk<BinT, kIds, kTimed, true>(ids, i0, i1, ghc, bins, F,
                                                 f0, nf, nb, tile, clk, lo);
  // tile element i = (feature f0 + i / (3 nb), bin lo + i / 3 % nb, i % 3)
  auto dst_of = [&](int i) {
    const int k = i / 3, fl = k / nb;
    return ((size_t)(f0 + fl) * B + lo + (k - fl * nb)) * 3 + (i - 3 * k);
  };
  if (chunks == 1 && out64 != nullptr) {
    for (int i = threadIdx.x; i < n3; i += kThreads)
      out64[dst_of(i)] = ltt::ids::tile_value(tile, i);
  } else if (chunks == 1) {
    for (int i = threadIdx.x; i < n3; i += kThreads)
      out[dst_of(i)] = (float)ltt::ids::tile_value(tile, i);
  } else {
    double* dst = partial + (size_t)c * F * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads)
      dst[dst_of(i)] = ltt::ids::tile_value(tile, i);
  }
  if constexpr (kTimed) {
    clk.lap(3);
    if (threadIdx.x == 0)
      for (int i = 0; i < 4; ++i)
        times[(size_t)blockIdx.x * 4 + i] = clk.acc[i];
  }
}

// out[i] = the chunks' partials summed in chunk order, rounded once (or
// into out64 unrounded)
__global__ void hist_rows_reduce(const double* __restrict__ partial,
                                 int chunks, long long n,
                                 float* __restrict__ out,
                                 double* __restrict__ out64) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = partial[i];
  for (int c = 1; c < chunks; ++c) s += partial[c * n + i];
  if (out64 != nullptr)
    out64[i] = s;
  else
    out[i] = (float)s;
}

template <typename BinT, bool kIds, bool kTimed>
int launch(const void* bins, const float* ghc, const int* ids,
           long long count, int F, int B, int feat_tile, int chunks,
           int win, double* partial, float* out, double* out64,
           unsigned long long* times, size_t smem, cudaStream_t stream) {
  // the attribute is set once per instance and size, not per launch
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_rows_kernel<BinT, kIds, kTimed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = chunks * ltt::ids::feature_tiles(F, feat_tile) *
                   ((B + win - 1) / win);
  hist_rows_kernel<BinT, kIds, kTimed><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), ghc, ids, count, F, B, feat_tile,
      chunks, win, partial, out, out64, times);
  return (int)cudaGetLastError();
}

template <typename BinT, bool kTimed>
int launch_ids(const void* bins, const float* ghc, const int* ids,
               long long count, int F, int B, int feat_tile, int chunks,
               int win, double* partial, float* out, double* out64,
               unsigned long long* times, size_t smem,
               cudaStream_t stream) {
  return ids ? launch<BinT, true, kTimed>(bins, ghc, ids, count, F, B,
                                          feat_tile, chunks, win, partial,
                                          out, out64, times, smem, stream)
             : launch<BinT, false, kTimed>(bins, ghc, ids, count, F, B,
                                           feat_tile, chunks, win, partial,
                                           out, out64, times, smem, stream);
}

template <bool kTimed>
int hist_rows(int bin_bytes, const void* bins, const float* ghc,
              const int* ids, long long count, int F, int B, int feat_tile,
              int max_chunks, double* partial, float* out, double* out64,
              unsigned long long* times, cudaStream_t stream) {
  const int max_b = bin_bytes == 1 ? 256 : bin_bytes == 2 ? 32768 : 65536;
  if (F < 1 || B < 1 || count < 0 || feat_tile < 1 ||
      feat_tile > ltt::ids::kMaxTile || B > max_b ||
      (bin_bytes != 1 && bin_bytes != 2 && bin_bytes != 4) ||
      max_chunks != ltt::ids::max_chunks_of(F, feat_tile) ||
      (kTimed && times == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = ltt::ids::child_chunks(count, max_chunks);
  if (chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int win = bin_window(bin_bytes, B, feat_tile);
  if (win < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ltt::ids::tile_smem_bytes(bin_bytes, win, feat_tile);
  int err;
  if (bin_bytes == 1)
    err = launch_ids<uint8_t, kTimed>(bins, ghc, ids, count, F, B,
                                      feat_tile, chunks, win, partial, out,
                                      out64, times, smem, stream);
  else if (bin_bytes == 2)
    err = launch_ids<uint16_t, kTimed>(bins, ghc, ids, count, F, B,
                                       feat_tile, chunks, win, partial, out,
                                       out64, times, smem, stream);
  else
    err = launch_ids<uint32_t, kTimed>(bins, ghc, ids, count, F, B,
                                       feat_tile, chunks, win, partial, out,
                                       out64, times, smem, stream);
  if (err || chunks == 1) return err;
  const long long n = (long long)F * B * 3;
  hist_rows_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, chunks, n, out, out64);
  return (int)cudaGetLastError();
}

}  // namespace

// bins [n, F] u8 (bin_bytes 1), u16 (2) or u32 (4); ghc [n, 3] f32;
// ids: count int32 row ids in row order, or null for rows [0, count)
// (count = n); feat_tile: the leaf kernel's (leaf_feat_tile);
// max_chunks = max_chunks_of(F, feat_tile); partial [max_chunks, F, B,
// 3] f64 (used when the call takes more than one chunk); out [F, B, 3]
// f32, or with out64 (not null) [F, B, 3] f64 sums, unrounded.
LTT_EXPORT int ltt_hist_rows(int bin_bytes, const void* bins,
                             const float* ghc, const int* ids,
                             long long count, int F, int B, int feat_tile,
                             int max_chunks, double* partial, float* out,
                             double* out64, cudaStream_t stream) {
  return hist_rows<false>(bin_bytes, bins, ghc, ids, count, F, B, feat_tile,
                          max_chunks, partial, out, out64, nullptr, stream);
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
                         max_chunks, partial, out, nullptr, times, stream);
}

// The window of bins one block of ltt_hist_rows takes (the grid has
// ceil(B / window) blocks a chunk and feature tile); 0 when no window
// fits.
LTT_EXPORT int ltt_hist_rows_window(int bin_bytes, int B, int feat_tile) {
  return bin_window(bin_bytes, B, feat_tile);
}
