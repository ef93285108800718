// Device code of the numerical best-split scan, shared by the per-phase
// kernel (split_scan.cu) and both fused split steps
// (split_step_segment.cu, split_step_leaf.cu). All are compiled with
// -fmad=false: the arithmetic follows lightgbm_tpu_torch/ops/split.py
// (per_feature_numerical, the plain version) expression by expression,
// and no multiply-add contraction may change a rounding.
//
// scan_feature finds one feature's best threshold of one leaf over its
// [B] g/h/c planes: both missing-value directions, L1/L2/max_delta_step,
// min_data/min_hessian, monotone bounds, the feature mask and penalty,
// with the reference's tie rules (largest threshold for the
// right-to-left scan, smallest for left-to-right, right-to-left wins
// ties). One scan is a chain of dependent steps inside one block, so
// its time is that chain's length, not memory (a feature's 3 x B floats
// are 12 KB at B = 1024). The chain, with three block barriers:
//  1. the block loads the feature's contiguous 3 x B floats as 16-byte
//     vectors into six padded planes, masked (load_planes) | barrier;
//  2. a plane a warp (plane_prefix): the prefix sums in float64,
//     rounded once per bin, in a fixed order that ops/split.py _cumsum
//     repeats with elementwise float64 adds: lane s sums its 32-bin
//     segment in bin order from 0.0 (keeping the 32 running sums in
//     registers, or adding them again), a warp scan (warp_scan) of the
//     segment totals gives each segment its exclusive offset, and each
//     bin is its running sum plus that offset (ops/split.py names this
//     order after block_prefix6, the two-pass block scan plane_prefix
//     replaced; the adds are the same). No shared totals | barrier;
//  3. every thread evaluates the two candidate splits of its bins (bin
//     b, b + blockDim.x, ...), the gain algebra only where the candidate
//     is valid (an invalid one scores -inf whatever its gain), and keeps
//     its best as one 64-bit key (cand_key) with the left sums of that
//     candidate; a warp's best by shuffles | barrier; warp 0 reduces the
//     warps' keys and thread 0 writes the row.
// The key orders (score, direction, threshold) totally, as the
// reference's tie rules do, so the winner does not depend on how the
// bins are dealt to threads: any block of a multiple of 32 threads finds
// the same split (the standalone kernel runs the block size its wrapper
// picks by measurement; the fused steps run 256 threads).
//
// The bin capacity kCap of the shared planes is a template parameter:
// kMaxBins (256) for the u8 layouts, kMaxScanBins (1024) for the u16
// leaf layout.
//
// Past 1024 bins (scan_feature_wide, the per-phase kernel's own
// instance) the planes are walked in windows of kScanWindow = 1024 bins
// through the same 26 KB of shared memory, up to kMaxWideBins = 65,536
// bins: the six planes of a wide feature (24 B a bin) would not fit a
// block past ~9,400 bins. A window's prefix is plane_prefix's, plus a
// float64 carry per plane: window 0 takes each segment's exclusive
// offset as it is, window w > 0 takes carry + offset, and the carry
// after a window is its total (window 0) or carry + its total. So at
// B <= 1024 the order is plane_prefix's to the add, and
// ops/split.py _cumsum repeats the windows. The right-to-left totals
// (the last bin of planes 3-5) are needed before any candidate, so a
// first pass runs the windows of planes 3-5 alone; the second runs all
// six and evaluates each window's bins, keeping every thread's best key
// across windows.
#pragma once

#include <math.h>

#include "common.cuh"

namespace ltt {

constexpr int kMaxBins = 256;       // bins of the u8 layouts
constexpr int kMaxScanBins = 1024;  // bins of one block of planes
constexpr int kScanWindow = 1024;   // bins a window past kMaxScanBins
constexpr int kMaxWideBins = 65536; // bins the wide scan takes
constexpr float kEps = 1e-15f;

struct Params {
  float l1, l2, mds, min_data, min_hess, min_gain;
};

struct Leaf {
  float pg, ph, pc, cmin, cmax;
};

__device__ __forceinline__ float sign_f(float s) {
  return s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  const float reg = fmaxf(fabsf(s) - l1, 0.f);
  return sign_f(s) * reg;
}

// leaf_output_no_constraint (feature_histogram.hpp:497-504)
__device__ __forceinline__ float out_nc(float g, float h, const Params& p) {
  float out = -threshold_l1(g, p.l1) / (h + p.l2);
  if (p.mds > 0.f) out = fminf(fmaxf(out, -p.mds), p.mds);
  return out;
}

__device__ __forceinline__ float out_c(float g, float h, const Params& p,
                                       float cmin, float cmax) {
  return fminf(fmaxf(out_nc(g, h, p), cmin), cmax);
}

__device__ __forceinline__ float gain_given(float g, float h, float w,
                                            const Params& p) {
  const float sg = threshold_l1(g, p.l1);
  return -(2.0f * sg * w + (h + p.l2) * w * w);
}

__device__ __forceinline__ float split_gains(float gl, float hl, float gr,
                                             float hr, int mono,
                                             const Params& p, float cmin,
                                             float cmax) {
  const float wl = out_c(gl, hl, p, cmin, cmax);
  const float wr = out_c(gr, hr, p, cmin, cmax);
  const float gain = gain_given(gl, hl, wl, p) + gain_given(gr, hr, wr, p);
  const bool violates = (mono > 0 && wl > wr) || (mono < 0 && wl < wr);
  return violates ? 0.f : gain;
}

// One candidate as a key whose unsigned order is the reference's: the
// larger score first; on equal scores the right-to-left scan (minus)
// before the left-to-right one, then the larger threshold for minus and
// the smaller for plus. The high word is the score's bits made
// monotone; a score is a gain above the shift (> 0) or -inf, never
// -0.0 or NaN, so float equality and key equality agree. Key 0 loses
// to every candidate (a thread without bins). t < 65536: the low word
// holds the direction at bit 16 and the threshold's order in bits 0-15.
__device__ __forceinline__ unsigned long long cand_key(float s, int t,
                                                       bool minus) {
  const unsigned u = __float_as_uint(s);
  const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const unsigned lo =
      minus ? 0x10000u | (unsigned)t : 0xffffu - (unsigned)t;
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ float key_score(unsigned long long k) {
  const unsigned hi = (unsigned)(k >> 32);
  return __uint_as_float((hi & 0x80000000u) ? hi & 0x7fffffffu : ~hi);
}

__device__ __forceinline__ bool key_minus(unsigned long long k) {
  return (k & 0x10000u) != 0;
}

__device__ __forceinline__ int key_threshold(unsigned long long k) {
  const unsigned lo = (unsigned)k & 0xffffu;
  return key_minus(k) ? (int)lo : (int)(0xffffu - lo);
}

// A candidate with its left sums (g, h + kEps, c).
struct Cand {
  unsigned long long key;
  float lg, lh, lc;
};

__device__ __forceinline__ void keep_better(Cand& best, unsigned long long k,
                                            float lg, float lh, float lc) {
  if (k > best.key) best = Cand{k, lg, lh, lc};
}

// The warp's best candidate to every lane (keys are distinct).
__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long k = __shfl_xor_sync(0xffffffffu, c.key, o);
    const float g = __shfl_xor_sync(0xffffffffu, c.lg, o);
    const float h = __shfl_xor_sync(0xffffffffu, c.lh, o);
    const float n = __shfl_xor_sync(0xffffffffu, c.lc, o);
    keep_better(c, k, g, h, n);
  }
  return c;
}

// Bin b of a plane sits at pad(b): one float of padding per 32 bins, so
// that lanes walking 32-bin segments side by side (plane_prefix) hit 32
// different banks.
__device__ __forceinline__ int pad(int b) { return b + (b >> 5); }

template <int kCap>
struct ScanSmem {
  float xs[6][kCap + kCap / 32];  // masked inputs, then prefix sums (pad)
  Cand red[32];                   // each warp's best candidate
};

// Inclusive scan of x over the warp's lanes: lane i adds the value of
// lane i - o for o = 1, 2, 4, 8, 16 (Kogge-Stone).
__device__ __forceinline__ double warp_scan(double x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Clock read i of a timed caller (kClock; thread 0 only).
template <bool kClock>
__device__ __forceinline__ void clock_at(unsigned long long* clk, int i) {
  if constexpr (kClock) {
    if (clk != nullptr && threadIdx.x == 0) clk[i] = clock64();
  }
}

// The feature's [B][3] floats at hist into the six planes, masked: planes
// 0-2 are g, h, c with the zero-missing default bin (skip_bin) zeroed;
// planes 3-5 also zero the NaN bin (na_bin), as the right-to-left scan
// needs. The whole block loads the contiguous 3 * B floats as 16-byte
// vectors (a scalar head up to the first 16-byte boundary and a scalar
// tail), every load of a thread in flight before its stores; from L2:
// a fused step's other blocks wrote this row in this launch.
template <int kCap>
__device__ __forceinline__ void load_planes(ScanSmem<kCap>& sm,
                                            const float* hist, int B,
                                            int skip_bin, int na_bin) {
  const int n3 = 3 * B;
  const int head = min(n3, (int)((16 - ((uintptr_t)hist & 15)) & 15) >> 2);
  const int nvec = (n3 - head) >> 2;
  auto put = [&](int e, float x) {
    const int b = e / 3, ch = e - 3 * b, pb = pad(b);
    const float xm = b == skip_bin ? 0.f : x;
    sm.xs[ch][pb] = xm;
    sm.xs[3 + ch][pb] = b == na_bin ? 0.f : xm;
  };
  for (int e = threadIdx.x; e < head; e += blockDim.x)
    put(e, __ldcg(hist + e));
  for (int e = head + 4 * nvec + threadIdx.x; e < n3; e += blockDim.x)
    put(e, __ldcg(hist + e));
  const float4* hv = reinterpret_cast<const float4*>(hist + head);
  for (int j0 = threadIdx.x; j0 < nvec; j0 += 4 * blockDim.x) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < nvec) v[u] = __ldcg(hv + j);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < nvec) {
        const int e = head + 4 * j;
        put(e, v[u].x);
        put(e + 1, v[u].y);
        put(e + 2, v[u].z);
        put(e + 3, v[u].w);
      }
    }
  }
}

// Plane c of sm.xs replaced by its prefix sums, by one whole warp (see
// the note at the top); the bins past B read as zeros. kHold keeps a
// segment's 32 running sums in registers (64 of them); without it a
// lane adds its segment again after the warp scan, the same adds in the
// same order, for a kernel whose other phases need the registers. The
// segment's floats are read from shared memory 8 at a time, so the
// chain is the float64 adds and not the loads.
template <int kCap, bool kHold>
__device__ __forceinline__ void plane_prefix(ScanSmem<kCap>& sm, int B,
                                             int c) {
  const int lane = threadIdx.x & 31;
  const int b0 = lane * 32;
  float* seg = sm.xs[c] + lane * 33;  // = pad(b0)
  double run[kHold ? 32 : 1];
  double acc = 0.0;
#pragma unroll
  for (int i0 = 0; i0 < 32; i0 += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = b0 + i0 + i < B ? seg[i0 + i] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc += (double)x[i];
      if constexpr (kHold) run[i0 + i] = acc;
    }
  }
  const double incl = warp_scan(acc, lane);
  const double ex = __shfl_up_sync(0xffffffffu, incl, 1);
  const double off = lane == 0 ? 0.0 : ex;
  if (b0 >= B) return;
  acc = 0.0;
#pragma unroll
  for (int i0 = 0; i0 < 32; i0 += 8) {
    float x[8];
    if constexpr (!kHold) {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = b0 + i0 + i < B ? seg[i0 + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (kHold) {
        acc = run[i0 + i];
      } else {
        acc += (double)x[i];
      }
      if (b0 + i0 + i < B) seg[i0 + i] = (float)(acc + off);
    }
  }
}

// What one leaf's candidates are held against (scan_feature's locals).
struct Eval {
  Leaf L;
  Params p;
  float ph_eps, min_gain_shift, tg, th, tc;
  int nb, defbin, mono, skip_bin, rand_bin;
  bool two_scan, na_excl, zero_miss;
};

// The two candidate splits of bin b (its prefix sums at pad index pb of
// sm's planes) into this thread's best.
template <int kCap>
__device__ __forceinline__ void eval_bin(const ScanSmem<kCap>& sm, int pb,
                                         int b, const Eval& e, Cand& best) {
  const Leaf& L = e.L;
  const Params& p = e.p;
  const bool rand_ok = e.rand_bin < 0 || b == e.rand_bin;
  // ---- dir=+1: left-to-right; default/NaN implicitly go right
  {
    const float lg = sm.xs[0][pb];
    const float hl = sm.xs[1][pb] + kEps;
    const float lc = sm.xs[2][pb];
    const float hr = e.ph_eps - hl;
    const float gr = L.pg - lg;
    const float cr = L.pc - lc;
    const bool valid = e.two_scan && b <= e.nb - 2 && b != e.skip_bin &&
                       rand_ok && lc >= p.min_data && cr >= p.min_data &&
                       hl >= p.min_hess && hr >= p.min_hess;
    float score = -INFINITY;
    if (valid) {
      const float gains =
          split_gains(lg, hl, gr, hr, e.mono, p, L.cmin, L.cmax);
      if (gains > e.min_gain_shift) score = gains;
    }
    keep_better(best, cand_key(score, b, false), lg, hl, lc);
  }
  // ---- dir=-1: right-to-left; default/NaN implicitly go left
  {
    const float rg = e.tg - sm.xs[3][pb];
    const float hr = (e.th - sm.xs[4][pb]) + kEps;
    const float rc = e.tc - sm.xs[5][pb];
    const float gl = L.pg - rg;
    const float hl = e.ph_eps - hr;
    const float cl = L.pc - rc;
    const bool valid = b <= e.nb - 2 - (e.na_excl ? 1 : 0) &&
                       !(e.zero_miss && b == e.defbin - 1) && rand_ok &&
                       cl >= p.min_data && rc >= p.min_data &&
                       hl >= p.min_hess && hr >= p.min_hess;
    float score = -INFINITY;
    if (valid) {
      const float gains =
          split_gains(gl, hl, rg, hr, e.mono, p, L.cmin, L.cmax);
      if (gains > e.min_gain_shift) score = gains;
    }
    keep_better(best, cand_key(score, b, true), gl, hl, cl);
  }
}

// The block's best of the threads' candidates into the row o (thread 0):
// a warp's best by shuffles | barrier; warp 0 reduces the warps' keys.
template <int kCap>
__device__ __forceinline__ void write_best(ScanSmem<kCap>& sm, Cand best,
                                           const Leaf& L, const Params& p,
                                           float penalty, float fmask,
                                           float min_gain_shift, int nb,
                                           int miss, float ph_eps,
                                           float* o) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  best = warp_best(best);
  if (lane == 0) sm.red[warp] = best;
  __syncthreads();
  if (warp != 0) return;
  best = lane < nwarps ? sm.red[lane] : Cand{0ull, 0.f, 0.f, 0.f};
  best = warp_best(best);
  if (lane == 0) {
    const bool use_m = key_minus(best.key);
    const float feat_gain = key_score(best.key);
    const int t = key_threshold(best.key);
    const bool valid = isfinite(feat_gain) && fmask > 0.f;
    const float score =
        valid ? (feat_gain - min_gain_shift) * penalty : -INFINITY;
    const bool dleft = use_m && !(nb <= 2 && miss == LTT_MISSING_NAN);
    o[0] = score;
    o[1] = (float)t;
    o[2] = best.lg;
    o[3] = best.lh;
    o[4] = best.lc;
    o[5] = dleft ? 1.f : 0.f;
    o[6] = out_c(best.lg, best.lh, p, L.cmin, L.cmax);
    o[7] = out_c(L.pg - best.lg, ph_eps - best.lh, p, L.cmin, L.cmax);
  }
}

// One (leaf, feature) row of the [K, F, 8] table (score, threshold,
// left g/h(+kEps)/c, default_left, left and right output) into o,
// written by thread 0. blockDim.x is a multiple of 32; B <= kCap. hist
// points at the feature's [B][3] planes. The block may call it again at
// once with the same sm (the fused steps' loop over features): the
// next call's loads follow this call's second barrier, after which no
// thread reads the planes. kHold: plane_prefix. With kClock, thread 0
// writes clock64 to clk[0, 5): entry, planes loaded, prefix sums (each
// after its barrier), its candidates, end. rand_bin >= 0 (extra_trees,
// from the per-phase scan's node table) makes that bin the only candidate
// threshold of both directions; -1 (the fused steps pass nothing) keeps
// every threshold.
template <int kCap, bool kClock = false, bool kHold = false>
__device__ __forceinline__ void scan_feature(const float* hist, int B,
                                             const Leaf& L, int nb, int miss,
                                             int defbin, int mono,
                                             float penalty, float fmask,
                                             const Params& p,
                                             ScanSmem<kCap>& sm, float* o,
                                             unsigned long long* clk =
                                                 nullptr,
                                             int rand_bin = -1) {
  clock_at<kClock>(clk, 0);
  const bool two_scan = miss != 0 && nb > 2;
  const bool na_excl = two_scan && miss == LTT_MISSING_NAN;
  const bool zero_miss = two_scan && miss == LTT_MISSING_ZERO;
  const int skip_bin = zero_miss ? defbin : -1;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  load_planes(sm, hist, B, skip_bin, na_excl ? nb - 1 : -1);
  __syncthreads();
  clock_at<kClock>(clk, 1);
  for (int c = warp; c < 6; c += nwarps) plane_prefix<kCap, kHold>(sm, B, c);
  __syncthreads();
  clock_at<kClock>(clk, 2);

  const float ph_eps = L.ph + 2e-15f;
  const float gain_shift = gain_given(L.pg, ph_eps, out_nc(L.pg, ph_eps, p), p);
  const float min_gain_shift = gain_shift + p.min_gain;
  const int plast = pad(B - 1);
  const float tg = sm.xs[3][plast], th = sm.xs[4][plast],
              tc = sm.xs[5][plast];
  const Eval e{L, p, ph_eps, min_gain_shift, tg, th, tc, nb, defbin, mono,
               skip_bin, rand_bin, two_scan, na_excl, zero_miss};
  Cand best{0ull, 0.f, 0.f, 0.f};
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    eval_bin(sm, pad(b), b, e, best);
  clock_at<kClock>(clk, 3);
  write_best<kCap>(sm, best, L, p, penalty, fmask, min_gain_shift, nb, miss,
                   ph_eps, o);
  clock_at<kClock>(clk, 4);
}

// Plane c of one window (Bw <= kCap bins in sm.xs) replaced by its prefix
// sums carried from the windows before it (see the note at the top),
// by one whole warp; carry is the plane's float64 carry (warp-uniform),
// updated here; first: window 0. The segment's adds are plane_prefix's
// without kHold: a lane sums its segment, and adds it again after the
// warp scan.
template <int kCap>
__device__ __forceinline__ void plane_prefix_carry(ScanSmem<kCap>& sm,
                                                   int Bw, int c,
                                                   double& carry,
                                                   bool first) {
  const int lane = threadIdx.x & 31;
  const int b0 = lane * 32;
  float* seg = sm.xs[c] + lane * 33;  // = pad(b0)
  double acc = 0.0;
#pragma unroll
  for (int i0 = 0; i0 < 32; i0 += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = b0 + i0 + i < Bw ? seg[i0 + i] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += (double)x[i];
  }
  const double incl = warp_scan(acc, lane);
  const double ex = __shfl_up_sync(0xffffffffu, incl, 1);
  const double total = __shfl_sync(0xffffffffu, incl, 31);
  const double ex0 = lane == 0 ? 0.0 : ex;
  const double off = first ? ex0 : carry + ex0;
  carry = first ? total : carry + total;
  if (b0 >= Bw) return;
  acc = 0.0;
#pragma unroll
  for (int i0 = 0; i0 < 32; i0 += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = b0 + i0 + i < Bw ? seg[i0 + i] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc += (double)x[i];
      if (b0 + i0 + i < Bw) seg[i0 + i] = (float)(acc + off);
    }
  }
}

// scan_feature past kMaxScanBins bins (B <= kMaxWideBins): the same row,
// from windows of kScanWindow bins (see the note at the top). Needs at
// least 6 warps: warp c owns plane c in every window, and with it that
// plane's carry. With kClock, clk[0, 5): entry, the first pass (the
// right-to-left totals), the second pass's prefix sums and candidates
// (both at its end), end.
template <bool kClock = false>
__device__ __forceinline__ void scan_feature_wide(
    const float* hist, int B, const Leaf& L, int nb, int miss, int defbin,
    int mono, float penalty, float fmask, const Params& p,
    ScanSmem<kScanWindow>& sm, float* o, unsigned long long* clk = nullptr,
    int rand_bin = -1) {
  clock_at<kClock>(clk, 0);
  const bool two_scan = miss != 0 && nb > 2;
  const bool na_excl = two_scan && miss == LTT_MISSING_NAN;
  const bool zero_miss = two_scan && miss == LTT_MISSING_ZERO;
  const int skip_bin = zero_miss ? defbin : -1;
  const int na_bin = na_excl ? nb - 1 : -1;
  const int warp = threadIdx.x >> 5;
  const int nwin = (B + kScanWindow - 1) / kScanWindow;
  // pass 1: planes 3-5 through every window, for the totals at bin B - 1
  double carry = 0.0;
  int bw = 0;
  for (int w = 0; w < nwin; ++w) {
    const int base = w * kScanWindow;
    bw = min(kScanWindow, B - base);
    __syncthreads();  // the last window's planes are read
    load_planes(sm, hist + (size_t)base * 3, bw, skip_bin - base,
                na_bin - base);
    __syncthreads();
    if (warp >= 3 && warp < 6)
      plane_prefix_carry<kScanWindow>(sm, bw, warp, carry, w == 0);
  }
  __syncthreads();
  const int plast = pad(bw - 1);
  const float tg = sm.xs[3][plast], th = sm.xs[4][plast],
              tc = sm.xs[5][plast];
  clock_at<kClock>(clk, 1);

  const float ph_eps = L.ph + 2e-15f;
  const float gain_shift = gain_given(L.pg, ph_eps, out_nc(L.pg, ph_eps, p), p);
  const float min_gain_shift = gain_shift + p.min_gain;
  const Eval e{L, p, ph_eps, min_gain_shift, tg, th, tc, nb, defbin, mono,
               skip_bin, rand_bin, two_scan, na_excl, zero_miss};
  Cand best{0ull, 0.f, 0.f, 0.f};
  // pass 2: all six planes, window by window, and the window's candidates
  carry = 0.0;
  for (int w = 0; w < nwin; ++w) {
    const int base = w * kScanWindow;
    bw = min(kScanWindow, B - base);
    __syncthreads();  // the last window's candidates are read
    load_planes(sm, hist + (size_t)base * 3, bw, skip_bin - base,
                na_bin - base);
    __syncthreads();
    if (warp < 6) plane_prefix_carry<kScanWindow>(sm, bw, warp, carry, w == 0);
    __syncthreads();
    for (int b = threadIdx.x; b < bw; b += blockDim.x)
      eval_bin(sm, pad(b), base + b, e, best);
  }
  clock_at<kClock>(clk, 2);
  clock_at<kClock>(clk, 3);
  write_best<kScanWindow>(sm, best, L, p, penalty, fmask, min_gain_shift,
                          nb, miss, ph_eps, o);
  clock_at<kClock>(clk, 4);
}

}  // namespace ltt
