// Multi-val histogram on Hopper: the [G_mv, B, 3] (sum grad, sum hess,
// count) histogram of the multi-val pseudo-groups of an EFB dataset, over
// all rows or over a list of row ids in row order.
//
// Replaces no Pallas kernel: the JAX package builds this histogram with
// an XLA scatter (lightgbm_tpu/ops/histogram.py:103 multival_hist, the
// reference's Dataset::ConstructHistogramsMultiVal). A pseudo-group has no
// column of the bin matrix; each row's values ride the slot matrix
// slots [N, K] int32, value p * 256 + offset + bin - 1 of pseudo-group p
// (data/bundling.py build_mv_slots), 0-padded. Every slot of a listed row
// adds the row's ghc (f32 [N, 3]) to the bin (p, value & 255) -- the
// padding too, which lands in pseudo-group 0, bin 0, a bin the debundle
// never reads (the JAX function adds it the same way). The output is the
// flat [G_mv, 256, 3] space cut or zero-padded to B bins.
//
// The sum rule (ROADMAP "Determinism and summation"): float64 sums in an
// order fixed by the data and the row count, rounded once to float32. A
// list of count rows is cut into chunks of about kChunkSlots slots (32 to
// 4096 rows, chunk_rows), at most kMaxVBlocks / windows of them (the
// count, K and G_mv alone: never the grid or the card); a block sums one (chunk, window) pair; the chunks' float64
// partials are summed in chunk order and rounded once. The plain version
// (ops/hist_multival_cuda.py hist_multival_plain) cuts the same chunks and
// sums each in float64.
//
// What bounds it on the H100: bytes in principle -- the row ids, the N*K
// slots and the rows' ghc read once (~0.8 GB of slots for 1M x 200, 0.25
// ms at 3.35 TB/s). This first design reads each slot once per window of
// pseudo-groups (a window's float64 bins fill a block's shared memory) and
// looks at it in every warp of the block, so it moves windows x the slot
// bytes and does warps x the slot work.
//
// Design: a block owns a window of W pseudo-groups (W * 256 * 3 float64
// bins in shared memory) and one chunk of rows. The block stages 32 rows
// at a time -- their ghc and their slots, kColBlock columns at a time --
// into shared memory; warp w owns the window's pseudo-groups w, w + 8,
// ..., so no two warps touch one bin. A warp takes the 32 staged rows as
// its lanes and walks the slot columns in order; in a column the lanes
// holding the same value of one of its groups find each other
// (__match_any_sync), and the lowest of them adds their ghc, summed in
// lane order, to the bin. So each bin's sum is fixed by the rows' order
// and slot layout; no float atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = 256;        // MV_SLOT_STRIDE
constexpr int kGroupRows = 32;      // rows staged a step (a lane a row)
constexpr int kColBlock = 128;      // slot columns staged a step
constexpr int kTileStride = kColBlock + 1;  // a staged row's ints: lanes
                                            // read a column conflict-free
constexpr int kChunkSlots = 1 << 17;  // slots (rows x K) a chunk ...
constexpr int kMinChunkRows = 32;     // ... in 32 to 4096 rows
constexpr int kMaxChunkRows = 4096;
constexpr int kMaxVBlocks = 1024;   // cap of chunks x windows
constexpr int kSmemBudget = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kTileBytes = kGroupRows * kTileStride * 4 + kGroupRows * 3 * 4;
constexpr int kGroupBytes = kStride * 3 * 8;

// Pseudo-groups a window holds (ops/hist_multival_cuda.py window_groups).
__host__ __device__ inline int window_groups(int g_mv) {
  const int w = (kSmemBudget - kTileBytes) / kGroupBytes;
  return w < g_mv ? w : g_mv;
}

__host__ __device__ inline int windows_of(int g_mv) {
  const int w = window_groups(g_mv);
  return (g_mv + w - 1) / w;
}

__host__ __device__ inline int max_chunks_of(int g_mv) {
  const int c = kMaxVBlocks / windows_of(g_mv);
  return c > 1 ? c : 1;
}

// Rows a chunk: about kChunkSlots slots, within [kMinChunkRows,
// kMaxChunkRows] (a narrow slot matrix keeps enough blocks busy).
__host__ __device__ inline long long chunk_rows(int K) {
  const long long r = kChunkSlots / K;
  return r < kMinChunkRows ? kMinChunkRows
                           : (r > kMaxChunkRows ? kMaxChunkRows : r);
}

__host__ __device__ inline int child_chunks(long long count, int K,
                                            int g_mv) {
  const long long c = (count + chunk_rows(K) - 1) / chunk_rows(K);
  const int m = max_chunks_of(g_mv);
  return (int)(c < 1 ? 1 : (c > m ? m : c));
}

template <bool kIds>
__global__ void __launch_bounds__(kThreads)
hist_multival_kernel(const int* __restrict__ slots, int K,
                     const float* __restrict__ ghc,
                     const int* __restrict__ ids, long long count, int g_mv,
                     int W, int chunks, int B, double* __restrict__ partial,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  double* bins = reinterpret_cast<double*>(dyn);
  int* stile = reinterpret_cast<int*>(bins + (size_t)W * kStride * 3);
  float* gtile = reinterpret_cast<float*>(stile + kGroupRows * kTileStride);
  const int nwin = (g_mv + W - 1) / W;
  const int c = blockIdx.x / nwin, win = blockIdx.x % nwin;
  const int g0 = win * W, nw = min(W, g_mv - g0);
  const int lo = g0 * kStride, hi = (g0 + nw) * kStride;
  const int nb = nw * kStride * 3;
  for (int i = threadIdx.x; i < nb; i += kThreads) bins[i] = 0.0;
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long r0 = i0; r0 < i1; r0 += kGroupRows) {
    const int nr = (int)min((long long)kGroupRows, i1 - r0);
    __syncthreads();   // the previous rows are consumed
    if (threadIdx.x < nr * 3) {
      const int r = threadIdx.x / 3, ch = threadIdx.x % 3;
      const long long row = kIds ? (long long)ids[r0 + r] : r0 + r;
      gtile[threadIdx.x] = ghc[row * 3 + ch];
    }
    for (int k0 = 0; k0 < K; k0 += kColBlock) {
      const int kc = min(kColBlock, K - k0);
      __syncthreads();
      for (int e = threadIdx.x; e < nr * kc; e += kThreads) {
        const int r = e / kc, j = e % kc;
        const long long row = kIds ? (long long)ids[r0 + r] : r0 + r;
        stile[r * kTileStride + j] = slots[row * K + k0 + j];
      }
      __syncthreads();
      for (int j = 0; j < kc; ++j) {
        const int v = lane < nr ? stile[lane * kTileStride + j] : -1;
        const bool mine =
            v >= lo && v < hi && ((v - lo) / kStride) % kWarps == warp;
        if (__ballot_sync(kFull, mine) == 0u) continue;
        const unsigned peers = __match_any_sync(kFull, mine ? v : -1);
        if (mine && __ffs(peers) - 1 == lane) {
          double sg = 0.0, sh = 0.0, sc = 0.0;
          for (unsigned p = peers; p; p &= p - 1) {
            const int l = __ffs(p) - 1;
            sg += (double)gtile[l * 3];
            sh += (double)gtile[l * 3 + 1];
            sc += (double)gtile[l * 3 + 2];
          }
          double* bin = bins + (size_t)(v - lo) * 3;
          bin[0] += sg;
          bin[1] += sh;
          bin[2] += sc;
        }
      }
    }
  }
  __syncthreads();
  if (chunks == 1) {
    const int n3 = nw * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads) {
      const int g = i / (B * 3), rest = i % (B * 3);
      const int b = rest / 3, ch = rest % 3;
      out[(size_t)(g0 + g) * B * 3 + rest] =
          b < kStride ? (float)bins[((size_t)g * kStride + b) * 3 + ch]
                      : 0.0f;
    }
  } else {
    double* dst = partial + ((size_t)c * g_mv + g0) * kStride * 3;
    for (int i = threadIdx.x; i < nb; i += kThreads) dst[i] = bins[i];
  }
}

// out[g, b, ch] = the chunks' partials of (g, b, ch) summed in chunk
// order, rounded once; bins at and past 256 are 0.
__global__ void hist_multival_reduce(const double* __restrict__ partial,
                                     int chunks, int g_mv, int B,
                                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)g_mv * B * 3;
  if (i >= n) return;
  const int g = (int)(i / (B * 3)), rest = (int)(i % (B * 3));
  const int b = rest / 3, ch = rest % 3;
  if (b >= kStride) {
    out[i] = 0.0f;
    return;
  }
  const long long plane = (long long)g_mv * kStride * 3;
  const long long at = ((long long)g * kStride + b) * 3 + ch;
  double s = partial[at];
#pragma unroll 8
  for (int c = 1; c < chunks; ++c) s += partial[c * plane + at];
  out[i] = (float)s;
}

template <bool kIds>
int launch(const int* slots, int K, const float* ghc, const int* ids,
           long long count, int g_mv, int W, int chunks, int B,
           double* partial, float* out, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_multival_kernel<kIds>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = chunks * ((g_mv + W - 1) / W);
  hist_multival_kernel<kIds><<<grid, kThreads, smem, stream>>>(
      slots, K, ghc, ids, count, g_mv, W, chunks, B, partial, out);
  return (int)cudaGetLastError();
}

}  // namespace

// slots [n, K] int32; ghc [n, 3] f32; ids: count int32 row ids in row
// order, or null for rows [0, count); g_mv pseudo-groups, B output bins;
// max_chunks = max_chunks_of(g_mv) (the partials' leading dimension,
// checked against the Python mirror); partial [max_chunks, g_mv, 256, 3]
// f64 (used when the call takes more than one chunk); out [g_mv, B, 3]
// f32.
LTT_EXPORT int ltt_hist_multival(const int* slots, int K, const float* ghc,
                                 const int* ids, long long count, int g_mv,
                                 int B, int max_chunks, double* partial,
                                 float* out, cudaStream_t stream) {
  if (K < 1 || g_mv < 1 || B < 1 || count < 0 ||
      max_chunks != max_chunks_of(g_mv))
    return (int)cudaErrorInvalidValue;
  const int W = window_groups(g_mv);
  const int chunks = child_chunks(count, K, g_mv);
  if (chunks > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * kGroupBytes + kTileBytes;
  const int err =
      ids ? launch<true>(slots, K, ghc, ids, count, g_mv, W, chunks, B,
                         partial, out, smem, stream)
          : launch<false>(slots, K, ghc, ids, count, g_mv, W, chunks, B,
                          partial, out, smem, stream);
  if (err || chunks == 1) return err;
  const long long n = (long long)g_mv * B * 3;
  hist_multival_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, chunks, g_mv, B, out);
  return (int)cudaGetLastError();
}
