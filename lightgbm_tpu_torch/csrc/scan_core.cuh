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
#pragma once

#include <math.h>

#include "common.cuh"

namespace ltt {

constexpr int kMaxBins = 256;       // bins of the u8 layouts
constexpr int kMaxScanBins = 1024;  // bins the scan takes (u16 layout)
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
// to every candidate (a thread without bins). t < 1024.
__device__ __forceinline__ unsigned long long cand_key(float s, int t,
                                                       bool minus) {
  const unsigned u = __float_as_uint(s);
  const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const unsigned lo = minus ? 0x800u | (unsigned)t : 0x3ffu - (unsigned)t;
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ float key_score(unsigned long long k) {
  const unsigned hi = (unsigned)(k >> 32);
  return __uint_as_float((hi & 0x80000000u) ? hi & 0x7fffffffu : ~hi);
}

__device__ __forceinline__ bool key_minus(unsigned long long k) {
  return (k & 0x800u) != 0;
}

__device__ __forceinline__ int key_threshold(unsigned long long k) {
  const unsigned lo = (unsigned)k & 0xfffu;
  return key_minus(k) ? (int)(lo & 0x3ffu) : (int)(0x3ffu - lo);
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  Cand best{0ull, 0.f, 0.f, 0.f};
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int pb = pad(b);
    const bool rand_ok = rand_bin < 0 || b == rand_bin;
    // ---- dir=+1: left-to-right; default/NaN implicitly go right
    {
      const float lg = sm.xs[0][pb];
      const float hl = sm.xs[1][pb] + kEps;
      const float lc = sm.xs[2][pb];
      const float hr = ph_eps - hl;
      const float gr = L.pg - lg;
      const float cr = L.pc - lc;
      const bool valid = two_scan && b <= nb - 2 && b != skip_bin &&
                         rand_ok && lc >= p.min_data && cr >= p.min_data &&
                         hl >= p.min_hess && hr >= p.min_hess;
      float score = -INFINITY;
      if (valid) {
        const float gains =
            split_gains(lg, hl, gr, hr, mono, p, L.cmin, L.cmax);
        if (gains > min_gain_shift) score = gains;
      }
      keep_better(best, cand_key(score, b, false), lg, hl, lc);
    }
    // ---- dir=-1: right-to-left; default/NaN implicitly go left
    {
      const float rg = tg - sm.xs[3][pb];
      const float hr = (th - sm.xs[4][pb]) + kEps;
      const float rc = tc - sm.xs[5][pb];
      const float gl = L.pg - rg;
      const float hl = ph_eps - hr;
      const float cl = L.pc - rc;
      const bool valid = b <= nb - 2 - (na_excl ? 1 : 0) &&
                         !(zero_miss && b == defbin - 1) && rand_ok &&
                         cl >= p.min_data && rc >= p.min_data &&
                         hl >= p.min_hess && hr >= p.min_hess;
      float score = -INFINITY;
      if (valid) {
        const float gains =
            split_gains(gl, hl, rg, hr, mono, p, L.cmin, L.cmax);
        if (gains > min_gain_shift) score = gains;
      }
      keep_better(best, cand_key(score, b, true), gl, hl, cl);
    }
  }
  clock_at<kClock>(clk, 3);
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
  clock_at<kClock>(clk, 4);
}

}  // namespace ltt
