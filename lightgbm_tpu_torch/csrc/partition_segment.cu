// Stable in-place partition of a row segment on Hopper.
//
// Replaces the TPU kernel _partition_kernel via partition_segment
// (lightgbm_tpu/ops/partition_pallas.py:51, :196). Rows
// [begin, begin + count) of the training matrix are reordered so the
// rows that go left come first, each side in its original order; whole
// rows move (bins, grad/hess payload, row id). The decision is
// rows_go_left's (lightgbm_tpu_torch/ops/partition.py, go_left in
// partition_core.cuh): a numerical threshold with missing codes
// none/zero/nan, default_left, default bin and bin count, or a 256-entry
// LUT for categorical / bundled splits.
//
// What bounds it on the H100: memory traffic, and at the per-phase
// path's segment sizes (~60k rows, ~3 MB) a launch's minimum device time.
// A stable partition needs the segment read once and written once,
// 2 * count * stride bytes at 3.35 TB/s; this moves twice that (into the
// workspace and back) in two launches, in the pattern of CUB's
// DevicePartition:
//  1. part_compact_kernel, a single-pass stable compaction into ws with
//     decoupled look-back. A block takes the next tile of kTileRows rows
//     from an atomic counter, so tiles are claimed in order whatever
//     order the blocks are scheduled in (a tile only waits on tiles
//     already claimed, so the wait always ends). It reads its rows'
//     bins (one byte a row), decides them once, publishes its left
//     count (flag A), and its warp 0 looks back over
//     the tiles before it (while every warp's row loads are in flight),
//     32 at a time, summing
//     their counts up to the nearest one that has published its
//     inclusive prefix (flag P), then publishes its own (P). The rights
//     before it are row0 - lefts_before, so no tile needs the total NL:
//     lefts land at ws[lefts_before + rank], rights from the back, in
//     reverse, at ws[count - 1 - (rights_before + rank)]. In-tile ranks
//     come from warp ballots; each warp copies its rows as 16-byte
//     vectors, neighbouring lanes on neighbouring vectors, so whole
//     sectors are written at once (a thread storing its own row's
//     vectors was 2.7x slower at 2M rows: partial sectors). The last
//     tile writes {begin, NL, begin + NL, count - NL}.
//  2. part_copy_back_kernel reads NL on the device and copies ws[0, NL)
//     to mat[begin, begin + NL) and ws[count - 1 - j] to
//     mat[begin + NL + j], which restores the rights' order; it resets
//     the tile counter for the next call. It is a programmatic dependent
//     launch: it launches while the compaction runs and waits for that
//     grid's end (griddepcontrol), so the second launch's latency hides.
// A tile's state is one 64-bit word (epoch and flag above, count below),
// so a reader sees the flag and its count together; the host passes a
// new epoch each call, so states need no reset. NL stays on the device,
// so a caller never has to wait for it.
#include "common.cuh"
#include "partition_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;  // rows a thread
constexpr int kGroups = kItems * kWarps;  // 32-row groups a tile
static_assert(kGroups <= 32, "warp 0 scans the groups, one a lane");
constexpr int kTileRows = kThreads * kItems;  // ops/partition_cuda.py mirrors
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFlagA = 1, kFlagP = 2;
using ltt::Decision;

__device__ __forceinline__ unsigned long long state_word(unsigned epoch,
                                                         unsigned flag,
                                                         int value) {
  return ((unsigned long long)((epoch << 2) | flag) << 32) |
         (unsigned)value;
}

// Warp 0: the left rows of all tiles before `tile` (see the note).
__device__ __forceinline__ int look_back(
    volatile unsigned long long* states, int tile, unsigned epoch,
    int lane) {
  int lefts = 0;
  for (int last = tile - 1;; last -= 32) {
    const int j = last - lane;
    unsigned long long w = 0;
    if (j >= 0) {
      do {
        w = states[j];
      } while ((unsigned)(w >> 34) != epoch);
    }
    const unsigned flag = (unsigned)(w >> 32) & 3u;
    const unsigned inc = __ballot_sync(kFull, j < 0 || flag == kFlagP);
    const int first = inc ? __ffs(inc) - 1 : 32;  // nearest P, or none
    int v = lane <= first && j >= 0 ? (int)(unsigned)w : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    lefts += v;
    if (inc) return lefts;
  }
}

// One tile (see the note). VPR = stride / 16 for rows of 32 to 64 bytes:
// each warp loads its groups' rows into registers before the look-back,
// so the loads and the look-back overlap; VPR = 0 (wider rows): each
// warp loads its rows after the look-back, a few vectors at a time.
template <int VPR>
__global__ void __launch_bounds__(kThreads)
part_compact_kernel(const uint8_t* __restrict__ mat,
                    uint8_t* __restrict__ ws, int stride, int begin,
                    int count, Decision d,
                    unsigned long long* __restrict__ scratch, unsigned epoch,
                    int ntiles, int* __restrict__ seg_out) {
  __shared__ int s_tile, s_lefts_before;
  __shared__ int s_off[kGroups];  // in-tile lefts before a group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the copy back may start launching (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;");

  // ---- claim the next tile, load its bins, one byte a row
  if (threadIdx.x == 0)
    s_tile = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int tile = s_tile;
  const long long row0 = (long long)tile * kTileRows;
  int bin[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long r = row0 + i * kThreads + threadIdx.x;
    bin[i] =
        r < count ? __ldg(mat + (size_t)(begin + r) * stride + d.feat) : -1;
  }
  volatile unsigned long long* states = scratch + 1;

  // ---- decide, ballots a 32-row group
  unsigned bl[kItems], br[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = bin[i] >= 0;
    const bool left = valid && ltt::go_left(bin[i], d);
    bl[i] = __ballot_sync(kFull, left);
    br[i] = __ballot_sync(kFull, valid && !left);
    if (lane == 0) s_off[i * kWarps + warp] = __popc(bl[i]);
  }

  // ---- the warp's rows, vector k = lane + 32 u of each group (held)
  constexpr int kV = VPR > 0 ? VPR : 1;
  int4 v[kItems][kV];
  if constexpr (VPR > 0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long g0 = row0 + (i * kWarps + warp) * 32;
      const int4* src =
          reinterpret_cast<const int4*>(mat + (size_t)(begin + g0) * stride);
#pragma unroll
      for (int u = 0; u < VPR; ++u) {
        const int k = u * 32 + lane;
        if (g0 + k / VPR < count) v[i][u] = __ldg(src + k);
      }
    }
  }
  __syncthreads();

  // ---- warp 0: in-tile offsets of the groups (row order: item-major),
  // publish, look back, publish the inclusive prefix
  if (warp == 0) {
    const int c = lane < kGroups ? s_off[lane] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane < kGroups) s_off[lane] = incl - c;
    const int total = __shfl_sync(kFull, incl, 31);
    if (lane == 0)
      states[tile] = state_word(epoch, tile == 0 ? kFlagP : kFlagA, total);
    const int before =
        tile == 0 ? 0 : look_back(states, tile, epoch, lane);
    if (lane == 0) {
      if (tile > 0) states[tile] = state_word(epoch, kFlagP, before + total);
      s_lefts_before = before;
      if (tile == ntiles - 1) {
        const int nl = before + total;
        seg_out[0] = begin;
        seg_out[1] = nl;
        seg_out[2] = begin + nl;
        seg_out[3] = count - nl;
      }
    }
  }
  __syncthreads();

  // ---- scatter: each warp stores its rows as 16-byte vectors,
  // neighbouring lanes on neighbouring vectors (whole sectors at once)
  const int lefts_before = s_lefts_before;
  const int rights_before = (int)row0 - lefts_before;
  const unsigned lt = (1u << lane) - 1u;
  const int vpr = VPR > 0 ? VPR : stride / 16;
  int4* dv = reinterpret_cast<int4*>(ws);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int g = i * kWarps + warp;
    const int off_l = s_off[g];
    const int off_r = g * 32 - off_l;  // in-tile rights before the group
    long long dest = -1;
    if (bl[i] >> lane & 1u)
      dest = lefts_before + off_l + __popc(bl[i] & lt);
    else if (br[i] >> lane & 1u)
      dest = (long long)count - 1 -
             (rights_before + off_r + __popc(br[i] & lt));
    if constexpr (VPR > 0) {
#pragma unroll
      for (int u = 0; u < VPR; ++u) {
        const int k = u * 32 + lane;
        const long long dr = __shfl_sync(kFull, dest, k / VPR);
        if (dr >= 0) dv[(size_t)dr * VPR + k % VPR] = v[i][u];
      }
    } else {
      const int4* src = reinterpret_cast<const int4*>(
          mat + (size_t)(begin + row0 + g * 32) * stride);
      for (int k0 = 0; k0 < 32 * vpr; k0 += 4 * 32) {
        int4 w[4];
        long long dr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u * 32 + lane;
          dr[u] = __shfl_sync(kFull, dest, min(k / vpr, 31));
          if (k < 32 * vpr && dr[u] >= 0) w[u] = __ldg(src + k);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u * 32 + lane;
          if (k < 32 * vpr && dr[u] >= 0)
            dv[(size_t)dr[u] * vpr + (k - (k / vpr) * vpr)] = w[u];
        }
      }
    }
  }
}

__global__ void part_copy_back_kernel(const int4* __restrict__ ws,
                                      int4* __restrict__ dst, int vpr,
                                      int count, const int* __restrict__ seg,
                                      unsigned long long* __restrict__
                                          counter) {
  // launched early (programmatic dependent launch): wait for the
  // compaction's grid to end and its writes to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (blockIdx.x == 0 && threadIdx.x == 0) *counter = 0;
  const long long nl = seg[1];
  const long long n = (long long)count * vpr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long j = i / vpr;
    const long long src = j < nl ? j : count - 1 - (j - nl);
    dst[i] = ws[src * vpr + (i - j * vpr)];
  }
}

}  // namespace

namespace {

// The two launches; vpr: the compaction's instantiation, the row's
// 16-byte vectors held in registers (2, 3 or 4) or 0, the rows loaded
// after the look-back (any stride).
int launch_partition(uint8_t* mat, uint8_t* ws, int stride, int begin,
                     int count, const Decision& d,
                     unsigned long long* scratch, int epoch, int* seg_out,
                     int vpr, cudaStream_t stream) {
  if (count < 0 || stride % 16 || epoch < 1 || epoch >= (1 << 30) ||
      (vpr != 0 && (vpr != stride / 16 || vpr < 2 || vpr > 4)))
    return (int)cudaErrorInvalidValue;
  const int ntiles = count > 0 ? (count + kTileRows - 1) / kTileRows : 1;
  auto compact = vpr == 2   ? part_compact_kernel<2>
                 : vpr == 3 ? part_compact_kernel<3>
                 : vpr == 4 ? part_compact_kernel<4>
                            : part_compact_kernel<0>;
  compact<<<ntiles, kThreads, 0, stream>>>(mat, ws, stride, begin, count, d,
                                           scratch, (unsigned)epoch, ntiles,
                                           seg_out);
  const int vecs = stride / 16;
  const long long nvec = (long long)count * vecs;
  const int blocks =
      (int)max(1ll, min((nvec + 255) / 256, (long long)132 * 16));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, part_copy_back_kernel, reinterpret_cast<const int4*>(ws),
      reinterpret_cast<int4*>(mat + (size_t)begin * stride), vecs, count,
      (const int*)seg_out, scratch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: device u64[1 + ceil(count / kTileRows)] (word 0 the tile
// counter, 0 before the first call and left 0 by every call; then the
// tile states); epoch: in [1, 2^30), different from the previous call's
// on this scratch; seg_out: device int32[4] = {begin, NL, begin + NL,
// count - NL}. Rows of 32, 48 or 64 bytes are held in registers, wider
// ones loaded after the look-back.
LTT_EXPORT int ltt_partition_segment(uint8_t* mat, uint8_t* ws, int stride,
                                     int begin, int count, int feat, int thr,
                                     int dleft, int miss, int defbin,
                                     int nbins, int use_lut, const float* lut,
                                     unsigned long long* scratch, int epoch,
                                     int* seg_out, cudaStream_t stream) {
  const Decision d{feat, thr, dleft, miss, defbin, nbins, use_lut, lut};
  const int vpr = stride / 16;
  return launch_partition(mat, ws, stride, begin, count, d, scratch, epoch,
                          seg_out, vpr >= 2 && vpr <= 4 ? vpr : 0, stream);
}

// For profiling only (chip_profile.py --partition): the same, with the
// compaction's instantiation the caller picks: vpr = stride / 16 (rows
// held, 32 to 64 bytes) or 0 (rows loaded after the look-back).
LTT_EXPORT int ltt_partition_segment_profile(
    uint8_t* mat, uint8_t* ws, int stride, int begin, int count, int feat,
    int thr, int dleft, int miss, int defbin, int nbins, int use_lut,
    const float* lut, unsigned long long* scratch, int epoch, int* seg_out,
    int vpr, cudaStream_t stream) {
  const Decision d{feat, thr, dleft, miss, defbin, nbins, use_lut, lut};
  return launch_partition(mat, ws, stride, begin, count, d, scratch, epoch,
                          seg_out, vpr, stream);
}

// The message of a CUDA error code, for the Python side's exceptions.
LTT_EXPORT const char* ltt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
