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
// adds the row's ghc (f32 [N, 3]) to the bin (p, value & 255); the padding
// (value 0) lands in pseudo-group 0, bin 0, a bin the debundle never
// reads (the JAX function adds it the same way). The output is the flat
// [G_mv, 256, 3] space cut or zero-padded to B bins.
//
// The layout (ops/hist_multival_cuda.py MultivalLayout, built once on the
// card from the static slots): pseudo-groups in windows of kWindowGroups;
// for window w and row r the row's real (non-padding) slots of that
// window, in slot order, as u16 window-local bins (g - w * kWindowGroups)
// * 256 + bin, at ent[off[w * N + r] .. off[w * N + r + 1]) (int64
// offsets); npad[r], the row's padding slots. A block of window w reads
// only that window's entries of its chunk's rows: every real slot is read
// once by the one block whose bins it hits. The padding is not read at
// all: bin (0, 0) gets npad[r] * ghc[r] a row (exact in float64).
//
// The sum rule (ROADMAP "Determinism and summation"): float64 sums in an
// order fixed by the data and the row count, rounded once to float32. A
// list of count rows is cut into chunks = clamp(ceil(count / kChunkRows),
// 1, max(1, kMaxVBlocks / windows)) chunks of ceil(count / chunks) list
// positions (the count and G_mv alone: never the grid or the card); a
// block sums one (chunk, window) pair; the chunks' float64 partials are
// summed in chunk order and rounded once. Inside a chunk, the per-bin add
// order: the chunk's rows are staged kStageRows at a time, their window
// entries (rows in list order, a row's entries in slot order) taken in
// passes of kBuf; a pass is sorted, stably, by the warp that owns each
// entry's bin (warp w owns the window's bins b with owner_of(b) == w),
// and each warp adds its run of the pass 32 entries at a time (the run's
// last few alone): into each bin they hit, the sum of that bin's entries
// in pass order (float64 from 0, one add a bin). Bin (0, 0) adds, a stage at a
// time, warp 0's fixed shuffle tree over its lanes' sums of npad * ghc
// (lane l the stage rows l, l + 32, ...). So every bin's sum is fixed by
// the data. The plain version (hist_multival_plain) cuts the same chunks
// and sums each in float64: a float64 sum of float32 values over a chunk
// is exact while the values' exponents span fewer than ~29 bits less
// log2 of the chunk's entries a bin, and then equal to the bit in any
// order; its chunk partials are summed in the same chunk order. The
// count channel must be a 0/1 indicator (make_ghc): the kernel counts it
// in integers, the plain version sums it in float64.
//
// What bounds it on the H100: bytes -- the row ids, the slots and the
// rows' ghc read once, the histogram written once (c's 1M x 200 slots:
// 0.24 ms at 3.35 TB/s; this kernel reads 0.29 GB of real entries and,
// for each of the 16 windows, a row's offset and ghc: ~0.6 GB, much of
// the ghc from L2). Its work is shared-memory and latency
// bound: a pass costs each row's thread a store of its row id at each of
// its positions, each thread 8 entry loads and a 64-bit block scan of
// its owners' counts (the stable sort), and each 32-entry group two
// peer-word round trips (hist_ids.cuh add_groups: no __match_any_sync).
// A window of 16 pseudo-groups leaves two blocks an SM (measured faster
// than one block of 32 groups).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStride = 256;         // MV_SLOT_STRIDE
constexpr int kWindowGroups = 16;    // pseudo-groups a window (two
                                     // blocks an SM)
constexpr int kStageRows = kThreads; // rows staged a step, one a thread
constexpr int kPer = 8;              // a pass's entries a thread
constexpr int kBuf = kThreads * kPer;  // staged entries a pass
constexpr int kChunkRows = 2048;     // list positions a chunk, at least
constexpr int kMaxVBlocks = 512;     // cap of chunks x windows
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kCountBit = 1u << 24;
constexpr unsigned kNone = 0xffffffffu;
constexpr unsigned long long kOnes16 = 0x0001000100010001ull;

__host__ __device__ inline int windows_of(int g_mv) {
  return (g_mv + kWindowGroups - 1) / kWindowGroups;
}

__host__ __device__ inline int max_chunks_of(int g_mv) {
  const int c = kMaxVBlocks / windows_of(g_mv);
  return c > 1 ? c : 1;
}

__host__ __device__ inline int child_chunks(long long count, int g_mv) {
  const long long c = (count + kChunkRows - 1) / kChunkRows;
  const int m = max_chunks_of(g_mv);
  return (int)(c < 1 ? 1 : (c > m ? m : c));
}

// Shared bytes of a block whose window holds W pseudo-groups: the bins
// (double2 (g, h), uint2 (peer word, count)), the stage's rows ((g, h),
// npad | count bit, entry start, entry offset), a pass's sorted entries
// and the scans' warp totals.
__host__ __device__ inline size_t smem_bytes(int W) {
  return (size_t)W * kStride * (sizeof(double2) + sizeof(uint2)) +
         kStageRows * (sizeof(float2) + sizeof(unsigned) +
                       sizeof(long long)) +
         kStageRows * sizeof(int) + kBuf * sizeof(unsigned) +
         kWarps * 2 * sizeof(unsigned long long) + 2 * kWarps * sizeof(int);
}

// The warp that owns window-local bin b: b's low 3 bits mixed with the
// next 3, so that a warp's bins fall in every shared-memory bank (with
// b % 8 every lane of a warp hit the same banks of gh and pc); bin 0 is
// warp 0's, which adds the padding there.
__device__ __forceinline__ int owner_of(unsigned b) {
  return (int)((b ^ (b >> 3)) & (kWarps - 1));
}

// 16-bit field i of a packed word of four counts
__device__ __forceinline__ unsigned fld(unsigned long long x, int i) {
  return (unsigned)(x >> (16 * i)) & 0xffffu;
}

// One warp adds a group of up to 32 sorted entries (lane < ne holds
// run[lane]): the lanes OR their bits into their bins' peer words, read
// them back, and the lowest lane of each word adds its own (g, h), then
// its peers' in lane order, and their count bits, then clears the word
// (hist_ids.cuh add_groups).
__device__ __forceinline__ void add_group(const unsigned* run, int ne,
                                          int lane, const float2* sgh,
                                          double2* gh, uint2* pc) {
  const bool ok = lane < ne;
  const unsigned e = ok ? run[lane] : 0u;
  const int b = (int)(e & 0xffffu);
  const float2 own = ok ? sgh[(e >> 16) & 0xffu] : make_float2(0.f, 0.f);
  if (ok) atomicOr(&pc[b].x, 1u << lane);
  __syncwarp();
  uint2 w = make_uint2(0u, 0u);
  if (ok) w = pc[b];
  __syncwarp();  // every lane's read lands before its leader clears
  if (ok && (w.x & ((1u << lane) - 1u)) == 0u) {
    double g = (double)own.x, h = (double)own.y;
    unsigned cnt = (e & kCountBit) ? 1u : 0u;
    for (unsigned mm = w.x & (w.x - 1u); mm; mm &= mm - 1u) {
      const unsigned pe = run[__ffs(mm) - 1];
      const float2 v = sgh[(pe >> 16) & 0xffu];
      g += (double)v.x;
      h += (double)v.y;
      cnt += (pe & kCountBit) ? 1u : 0u;
    }
    double2 d = gh[b];
    d.x += g;
    d.y += h;
    gh[b] = d;
    pc[b] = make_uint2(0u, w.y + cnt);
  }
  __syncwarp();  // this group's adds land before the next group's
}

// kTimed: thread 0 of every block adds its cycles of staging, the
// passes' loads and sorts, the accumulation and the write-out, and the
// block's entries, into times[block] (chip_profile.py --multival-phases).
// out == nullptr (the float64 route): every block writes its chunk's
// partial, the one-chunk call's too, and the reduce writes float64.
template <bool kIds, bool kTimed>
__global__ void __launch_bounds__(kThreads)
hist_multival_kernel(const unsigned short* __restrict__ ent,
                     const long long* __restrict__ off, long long n,
                     const int* __restrict__ npad,
                     const float* __restrict__ ghc,
                     const int* __restrict__ ids, long long count, int g_mv,
                     int W, int chunks, int B, double* __restrict__ partial,
                     float* __restrict__ out, long long* times) {
  extern __shared__ __align__(16) unsigned char dyn[];
  double2* gh = reinterpret_cast<double2*>(dyn);
  uint2* pc = reinterpret_cast<uint2*>(gh + (size_t)W * kStride);
  long long* soff = reinterpret_cast<long long*>(pc + (size_t)W * kStride);
  unsigned long long* wscan =
      reinterpret_cast<unsigned long long*>(soff + kStageRows);
  float2* sgh = reinterpret_cast<float2*>(wscan + 2 * kWarps);
  unsigned* sinfo = reinterpret_cast<unsigned*>(sgh + kStageRows);
  int* sstart = reinterpret_cast<int*>(sinfo + kStageRows);
  int* wsum = sstart + kStageRows;
  unsigned* buf = reinterpret_cast<unsigned*>(wsum + 2 * kWarps);

  unsigned long long t_last = 0, acc[5] = {0, 0, 0, 0, 0};
  if constexpr (kTimed) t_last = clock64();
  auto lap = [&](int i) {
    if constexpr (kTimed) {
      const unsigned long long now = clock64();
      acc[i] += now - t_last;
      t_last = now;
    }
  };

  const int nwin = windows_of(g_mv);
  const int c = blockIdx.x / nwin, win = blockIdx.x % nwin;
  const int g0 = win * W, nw = min(W, g_mv - g0);
  const int nb = nw * kStride;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    gh[i] = make_double2(0.0, 0.0);
    pc[i] = make_uint2(0u, 0u);
  }
  const long long chunk = (count + chunks - 1) / chunks;
  const long long i0 = min(count, (long long)c * chunk);
  const long long i1 = min(count, i0 + chunk);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long* woff = off + (long long)win * n;
  for (long long s0 = i0; s0 < i1; s0 += kStageRows) {
    const int m = (int)min((long long)kStageRows, i1 - s0);
    __syncthreads();  // the last stage is consumed (and the bins zeroed)
    int len = 0;
    if (t < m) {
      const long long row = kIds ? (long long)__ldg(ids + s0 + t) : s0 + t;
      const float* gp = ghc + row * 3;
      sgh[t] = make_float2(gp[0], gp[1]);
      const long long a = woff[row];
      soff[t] = a;
      len = (int)(woff[row + 1] - a);
      sinfo[t] = (win == 0 ? (unsigned)npad[row] : 0u) |
                 (gp[2] != 0.0f ? 1u << 31 : 0u);
    }
    // exclusive scan of the stage's entry counts: sstart[r], and the
    // stage's total
    int v = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int x = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int u = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += u;
      }
      if (lane < kWarps) wsum[kWarps + lane] = x;
    }
    __syncthreads();
    const int total = wsum[2 * kWarps - 1];
    const int start = v - len + (warp ? wsum[kWarps + warp - 1] : 0);
    sstart[t] = start;
    // bin (0, 0): the stage's padding, npad * ghc (exact), warp 0 of the
    // window-0 block, a fixed shuffle tree
    if (win == 0 && warp == 0) {
      double pg = 0.0, ph = 0.0;
      unsigned pcnt = 0u;
      for (int r = lane; r < m; r += 32) {
        const unsigned info = sinfo[r];
        const double k = (double)(info & 0x7fffffffu);
        pg += k * (double)sgh[r].x;
        ph += k * (double)sgh[r].y;
        pcnt += (info >> 31) ? (info & 0x7fffffffu) : 0u;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        pg += __shfl_xor_sync(kFull, pg, o);
        ph += __shfl_xor_sync(kFull, ph, o);
        pcnt += __shfl_xor_sync(kFull, pcnt, o);
      }
      if (lane == 0) {
        double2 d = gh[0];
        d.x += pg;
        d.y += ph;
        gh[0] = d;
        pc[0].y += pcnt;
      }
    }
    lap(0);
    for (int e0 = 0; e0 < total; e0 += kBuf) {
      const int ne = min(kBuf, total - e0);
      __syncthreads();  // sstart is written; the last pass is consumed
      // each position's row (and its count bit), written by the row's
      // thread into the pass buffer's space, read before the sort
      unsigned short* prow = reinterpret_cast<unsigned short*>(buf);
      if (t < m) {
        const unsigned short tr =
            (unsigned short)(t | ((sinfo[t] >> 31) ? 0x100 : 0));
        const int hi = min(start + len, e0 + ne);
        for (int q = max(start, e0); q < hi; ++q) prow[q - e0] = tr;
      }
      __syncthreads();
      // this thread's kPer consecutive positions of the pass, their loads
      // issued together
      const int p0 = e0 + t * kPer;
      long long at[kPer];
      unsigned tag[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int p = p0 + u;
        at[u] = -1;
        tag[u] = 0u;
        if (p < e0 + ne) {
          const unsigned tr = prow[p - e0];
          const int r = (int)(tr & 0xffu);
          at[u] = soff[r] + (p - sstart[r]);
          tag[u] = ((unsigned)r << 16) | ((tr & 0x100u) ? kCountBit : 0u);
        }
      }
      unsigned ev[kPer];
      unsigned long long cl = 0ull, chh = 0ull;  // owners 0-3, 4-7
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        ev[u] = at[u] >= 0 ? (unsigned)__ldg(ent + at[u]) | tag[u] : kNone;
        if (ev[u] != kNone) {
          const int o = owner_of(ev[u] & 0xffffu);
          const unsigned long long inc = 1ull << (16 * (o & 3));
          if (o < 4) cl += inc; else chh += inc;
        }
      }
      // block exclusive scan of the packed owner counts (every prow read
      // is done before the barrier in it; buf is written after)
      unsigned long long il = cl, ih = chh;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long ul = __shfl_up_sync(kFull, il, o);
        const unsigned long long uh = __shfl_up_sync(kFull, ih, o);
        if (lane >= o) {
          il += ul;
          ih += uh;
        }
      }
      if (lane == 31) {
        wscan[2 * warp] = il;
        wscan[2 * warp + 1] = ih;
      }
      __syncthreads();
      unsigned long long pl = il - cl, ph = ih - chh, tl = 0ull, th = 0ull;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        const unsigned long long ql = wscan[2 * q], qh = wscan[2 * q + 1];
        if (q < warp) {
          pl += ql;
          ph += qh;
        }
        tl += ql;
        th += qh;
      }
      // the owners' runs: owner o's starts at the pass's count of lower
      // owners (prefix sums of packed fields by one multiply)
      const unsigned long long sl = tl * kOnes16, sh = th * kOnes16;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (ev[u] == kNone) continue;
        const int o = owner_of(ev[u] & 0xffffu);
        unsigned base;
        if (o < 4) {
          base = fld(sl, o) - fld(tl, o) + fld(pl, o);
          pl += 1ull << (16 * o);
        } else {
          base = fld(sl, 3) + fld(sh, o - 4) - fld(th, o - 4) + fld(ph, o - 4);
          ph += 1ull << (16 * (o - 4));
        }
        buf[base] = ev[u];
      }
      __syncthreads();
      lap(1);
      const unsigned r0 = warp < 4 ? fld(sl, warp) - fld(tl, warp)
                                   : fld(sl, 3) + fld(sh, warp - 4) -
                                         fld(th, warp - 4);
      const unsigned r1 = r0 + (warp < 4 ? fld(tl, warp) : fld(th, warp - 4));
      for (unsigned g = r0; g < r1; g += 32)
        add_group(buf + g, (int)min(32u, r1 - g), lane, sgh, gh, pc);
      if constexpr (kTimed) acc[4] += ne;
      lap(2);
    }
  }
  __syncthreads();
  const int bw = min(B, kStride);
  if (chunks == 1 && out != nullptr) {
    const int n3 = nw * B * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads) {
      const int g = i / (B * 3), rest = i % (B * 3);
      const int b = rest / 3, ch = rest % 3;
      float x = 0.0f;
      if (b < kStride) {
        const int k = g * kStride + b;
        x = (float)(ch == 0 ? gh[k].x : ch == 1 ? gh[k].y : (double)pc[k].y);
      }
      out[(size_t)(g0 + g) * B * 3 + rest] = x;
    }
  } else {
    double* dst = partial + ((size_t)c * g_mv + g0) * bw * 3;
    const int n3 = nw * bw * 3;
    for (int i = threadIdx.x; i < n3; i += kThreads) {
      const int g = i / (bw * 3), rest = i % (bw * 3);
      const int k = g * kStride + rest / 3, ch = rest % 3;
      dst[i] = ch == 0 ? gh[k].x : ch == 1 ? gh[k].y : (double)pc[k].y;
    }
  }
  if constexpr (kTimed) {
    __syncthreads();
    lap(3);
    if (threadIdx.x == 0)
      for (int i = 0; i < 5; ++i) times[blockIdx.x * 5 + i] = (long long)acc[i];
  }
}

// out[g, b, ch] = the chunks' partials of (g, b, ch) summed in chunk
// order, rounded once (T float), or unrounded (T double: the float64
// route); bins at and past 256 are 0.
template <typename T>
__global__ void hist_multival_reduce(const double* __restrict__ partial,
                                     int chunks, int g_mv, int B,
                                     T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)g_mv * B * 3;
  if (i >= n) return;
  const int g = (int)(i / (B * 3)), rest = (int)(i % (B * 3));
  const int b = rest / 3, ch = rest % 3;
  if (b >= kStride) {
    out[i] = (T)0;
    return;
  }
  const int bw = min(B, kStride);
  const long long plane = (long long)g_mv * bw * 3;
  const long long at = ((long long)g * bw + b) * 3 + ch;
  double s = partial[at];
#pragma unroll 8
  for (int c = 1; c < chunks; ++c) s += partial[c * plane + at];
  out[i] = (T)s;
}

template <bool kIds, bool kTimed>
int launch(const unsigned short* ent, const long long* off, long long n,
           const int* npad, const float* ghc, const int* ids,
           long long count, int g_mv, int W, int chunks, int B,
           double* partial, float* out, size_t smem, long long* times,
           cudaStream_t stream) {
  static size_t smem_set = 0;
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_multival_kernel<kIds, kTimed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int grid = chunks * windows_of(g_mv);
  hist_multival_kernel<kIds, kTimed><<<grid, kThreads, smem, stream>>>(
      ent, off, n, npad, ghc, ids, count, g_mv, W, chunks, B, partial, out,
      times);
  return (int)cudaGetLastError();
}

// out64 non-null: the float64 route (out is null), the chunks' partials
// summed into out64 unrounded, whatever the chunk count.
template <bool kTimed>
int run(const unsigned short* ent, const long long* off, long long n,
        const int* npad, const float* ghc, const int* ids, long long count,
        int g_mv, int B, int max_chunks, double* partial, float* out,
        double* out64, long long* times, cudaStream_t stream) {
  if (n < 0 || g_mv < 1 || B < 1 || count < 0 ||
      max_chunks != max_chunks_of(g_mv))
    return (int)cudaErrorInvalidValue;
  const int W = g_mv < kWindowGroups ? g_mv : kWindowGroups;
  const int chunks = child_chunks(count, g_mv);
  if ((chunks > 1 || out64 != nullptr) && partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W);
  const int err =
      ids ? launch<true, kTimed>(ent, off, n, npad, ghc, ids, count, g_mv, W,
                                 chunks, B, partial, out, smem, times, stream)
          : launch<false, kTimed>(ent, off, n, npad, ghc, ids, count, g_mv,
                                  W, chunks, B, partial, out, smem, times,
                                  stream);
  const long long total = (long long)g_mv * B * 3;
  const unsigned grid = (unsigned)((total + 255) / 256);
  if (err) return err;
  if (out64 != nullptr)
    hist_multival_reduce<double><<<grid, 256, 0, stream>>>(partial, chunks,
                                                           g_mv, B, out64);
  else if (chunks > 1)
    hist_multival_reduce<float><<<grid, 256, 0, stream>>>(partial, chunks,
                                                          g_mv, B, out);
  else
    return 0;
  return (int)cudaGetLastError();
}

}  // namespace

// The layout (ops/hist_multival_cuda.py MultivalLayout): ent u16 window-
// local bins, off int64 [windows * n + 1], npad int32 [n]; ghc [n, 3] f32;
// ids: count int32 row ids in row order, or null for rows [0, count);
// g_mv pseudo-groups, B output bins; max_chunks = max_chunks_of(g_mv)
// (the partials' leading dimension, checked against the Python mirror);
// partial [max_chunks, g_mv, min(B, 256), 3] f64 (used when the call
// takes more than one chunk, and always on the float64 route); exactly
// one of out [g_mv, B, 3] f32 (rounded once) and out64 [g_mv, B, 3] f64
// (the float64 route: the data-parallel learners' all-reduce rounds
// once, so the chunk-ordered sum of the partials is written unrounded);
// times: null, or int64 [grid, 5] for the timed instantiation.
LTT_EXPORT int ltt_hist_multival(const unsigned short* ent,
                                 const long long* off, long long n,
                                 const int* npad, const float* ghc,
                                 const int* ids, long long count, int g_mv,
                                 int B, int max_chunks, double* partial,
                                 float* out, double* out64,
                                 long long* times, cudaStream_t stream) {
  if ((out == nullptr) == (out64 == nullptr))
    return (int)cudaErrorInvalidValue;
  return times ? run<true>(ent, off, n, npad, ghc, ids, count, g_mv, B,
                           max_chunks, partial, out, out64, times, stream)
               : run<false>(ent, off, n, npad, ghc, ids, count, g_mv, B,
                            max_chunks, partial, out, out64, nullptr,
                            stream);
}
