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
// ties). The six prefix sums (2 directions x 3 channels) are block
// scans in double, rounded once per bin (block_prefix6: a fixed order
// that ops/split.py _cumsum repeats with elementwise float64 adds);
// then every thread evaluates the two candidate splits of its bins
// (bin b, b + blockDim.x, ...), and a block argmax with (score,
// threshold) ordering picks each direction's winner. The (score,
// threshold) order is total, so the winner does not depend on how the
// bins are dealt to threads: a block of at least B threads (one bin
// each, as split_scan.cu launches it) and a 256-thread block walking
// 1024 bins find the same split.
//
// The bin capacity kCap of the shared planes is a template parameter:
// kMaxBins (256) keeps the u8 kernels' static footprint; kMaxScanBins
// (1024) serves the u16 leaf layout from dynamic shared memory
// (12 x 1024 floats do not fit the 48 KB static limit).
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

// (score, t) total order; `last` prefers the larger t on equal scores
__device__ __forceinline__ bool better(float sa, int ta, float sb, int tb,
                                       bool last) {
  if (sa != sb) return sa > sb;
  return last ? ta > tb : ta < tb;
}

__device__ __forceinline__ void block_argmax(float s, int t, bool last,
                                             float* red_s, int* red_t,
                                             float* out_s, int* out_t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    const int t2 = __shfl_xor_sync(0xffffffffu, t, o);
    if (better(s2, t2, s, t, last)) {
      s = s2;
      t = t2;
    }
  }
  if (lane == 0) {
    red_s[warp] = s;
    red_t[warp] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = red_s[0];
    int bt = red_t[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (better(red_s[w], red_t[w], bs, bt, last)) {
        bs = red_s[w];
        bt = red_t[w];
      }
    *out_s = bs;
    *out_t = bt;
  }
  __syncthreads();
}

// Bin b of a plane sits at pad(b): one float of padding per 32 bins, so
// that threads walking 32-bin segments side by side (block_prefix6)
// hit 32 different banks.
__device__ __forceinline__ int pad(int b) { return b + (b >> 5); }

template <int kCap>
struct ScanSmem {
  static_assert(kCap >= 128, "the segment offsets share lp's memory");
  float xs[6][kCap + kCap / 32];  // masked inputs, then prefix sums (pad)
  union {
    float lp[3][kCap];   // left sums of the +1 scan
    double seg[6][32];   // block_prefix6's segment totals, then offsets
  };
  float lm[3][kCap];  // left sums of the -1 scan
  float red_s[32];
  int red_t[32];
  float win_s[2];
  int win_t[2];
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

// The six planes sm.xs[0..6)[0, B) replaced by their prefix sums,
// accumulated in double and rounded once per bin. The order is fixed,
// so the result is bitwise repeatable and ops/split.py _cumsum (the
// plain version) repeats it: the bins in 32-bin segments, each summed
// in bin order by one thread from 0.0 (the last segment padded with
// zeros), a warp scan (warp_scan) of each plane's segment totals, and
// each bin's running sum plus its segment's exclusive offset (0.0 for
// the first). blockDim.x is a multiple of 32.
template <int kCap>
__device__ __forceinline__ void block_prefix6(ScanSmem<kCap>& sm, int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nseg = (B + 31) >> 5, ntask = 6 * nseg;
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0 keeps each segment's total, pass 1 writes the prefixes;
    // 8 bins' loads in flight at a time
    for (int t = threadIdx.x; t < ntask; t += blockDim.x) {
      const int c = t / nseg, sg = t % nseg, b0 = sg * 32;
      float* xc = sm.xs[c] + pad(b0);
      const double off = pass == 0 ? 0.0 : sm.seg[c][sg];
      double acc = 0.0;
      for (int i0 = 0; i0 < 32; i0 += 8) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = b0 + i0 + i < B ? xc[i0 + i] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc += (double)x[i];
          if (pass == 1 && b0 + i0 + i < B) xc[i0 + i] = (float)(acc + off);
        }
      }
      if (pass == 0) sm.seg[c][sg] = acc;
    }
    __syncthreads();
    if (pass == 0) {
      // exclusive offsets of the segments, one warp per plane
      for (int c = warp; c < 6; c += nwarps) {
        const double t = warp_scan(lane < nseg ? sm.seg[c][lane] : 0.0, lane);
        const double ex = __shfl_up_sync(0xffffffffu, t, 1);
        sm.seg[c][lane] = lane == 0 ? 0.0 : ex;
      }
      __syncthreads();
    }
  }
}

// Clock read i of a timed caller (kClock; thread 0 only).
template <bool kClock>
__device__ __forceinline__ void clock_at(unsigned long long* clk, int i) {
  if constexpr (kClock) {
    if (clk != nullptr && threadIdx.x == 0) clk[i] = clock64();
  }
}

// One (leaf, feature) row of the [K, F, 8] table (score, threshold,
// left g/h(+kEps)/c, default_left, left and right output) into o.
// blockDim.x is a multiple of 32; B <= kCap. hist points at the
// feature's [B][3] planes. With kClock, thread 0 writes clock64 to
// clk[0, 5): entry, planes loaded, prefix sums, candidates, end.
template <int kCap, bool kClock = false>
__device__ __forceinline__ void scan_feature(const float* hist, int B,
                                             const Leaf& L, int nb, int miss,
                                             int defbin, int mono,
                                             float penalty, float fmask,
                                             const Params& p,
                                             ScanSmem<kCap>& sm, float* o,
                                             unsigned long long* clk =
                                                 nullptr) {
  clock_at<kClock>(clk, 0);
  const bool two_scan = miss != 0 && nb > 2;
  const bool na_excl = two_scan && miss == LTT_MISSING_NAN;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const bool skip_default = two_scan && miss == LTT_MISSING_ZERO &&
                              b == defbin;
    const bool is_na_bin = na_excl && b == nb - 1;
    for (int ch = 0; ch < 3; ++ch) {
      // from L2: a fused step's other blocks wrote this row in this launch
      const float x = __ldcg(hist + b * 3 + ch);
      sm.xs[ch][pad(b)] = skip_default ? 0.f : x;
      sm.xs[3 + ch][pad(b)] = (skip_default || is_na_bin) ? 0.f : x;
    }
  }
  __syncthreads();
  clock_at<kClock>(clk, 1);
  block_prefix6(sm, B);
  clock_at<kClock>(clk, 2);

  const float ph_eps = L.ph + 2e-15f;
  const float gain_shift = gain_given(L.pg, ph_eps, out_nc(L.pg, ph_eps, p), p);
  const float min_gain_shift = gain_shift + p.min_gain;
  // each thread's best of its bins per direction; the initial
  // thresholds lose every tie, as a padding thread's do
  float best_m = -INFINITY, best_p = -INFINITY;
  int t_m = -1, t_p = 0x7fffffff;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const bool skip_default = two_scan && miss == LTT_MISSING_ZERO &&
                              b == defbin;
    float score_p = -INFINITY, score_m = -INFINITY;
    // ---- dir=+1: left-to-right; default/NaN implicitly go right
    const int pb = pad(b), plast = pad(B - 1);
    const float lg_p = sm.xs[0][pb];
    const float hl_p = sm.xs[1][pb] + kEps;
    const float lc_p = sm.xs[2][pb];
    const float hr_p = ph_eps - hl_p;
    const float gr_p = L.pg - lg_p;
    const float cr_p = L.pc - lc_p;
    const bool valid_p = two_scan && b <= nb - 2 && !skip_default &&
                         lc_p >= p.min_data && cr_p >= p.min_data &&
                         hl_p >= p.min_hess && hr_p >= p.min_hess;
    const float gains_p =
        split_gains(lg_p, hl_p, gr_p, hr_p, mono, p, L.cmin, L.cmax);
    if (valid_p && gains_p > min_gain_shift) score_p = gains_p;
    sm.lp[0][b] = lg_p;
    sm.lp[1][b] = hl_p;
    sm.lp[2][b] = lc_p;

    // ---- dir=-1: right-to-left; default/NaN implicitly go left
    const float rg_m = sm.xs[3][plast] - sm.xs[3][pb];
    const float hr_m = (sm.xs[4][plast] - sm.xs[4][pb]) + kEps;
    const float rc_m = sm.xs[5][plast] - sm.xs[5][pb];
    const float gl_m = L.pg - rg_m;
    const float hl_m = ph_eps - hr_m;
    const float cl_m = L.pc - rc_m;
    bool valid_m = b <= nb - 2 - (na_excl ? 1 : 0);
    valid_m = valid_m &&
              !(two_scan && miss == LTT_MISSING_ZERO && b == defbin - 1);
    valid_m = valid_m && cl_m >= p.min_data && rc_m >= p.min_data &&
              hl_m >= p.min_hess && hr_m >= p.min_hess;
    const float gains_m =
        split_gains(gl_m, hl_m, rg_m, hr_m, mono, p, L.cmin, L.cmax);
    if (valid_m && gains_m > min_gain_shift) score_m = gains_m;
    sm.lm[0][b] = gl_m;
    sm.lm[1][b] = hl_m;
    sm.lm[2][b] = cl_m;
    if (better(score_m, b, best_m, t_m, true)) {
      best_m = score_m;
      t_m = b;
    }
    if (better(score_p, b, best_p, t_p, false)) {
      best_p = score_p;
      t_p = b;
    }
  }
  clock_at<kClock>(clk, 3);
  block_argmax(best_m, t_m, true, sm.red_s, sm.red_t, &sm.win_s[0],
               &sm.win_t[0]);
  block_argmax(best_p, t_p, false, sm.red_s, sm.red_t, &sm.win_s[1],
               &sm.win_t[1]);

  if (threadIdx.x == 0) {
    const float v_m = sm.win_s[0], v_p = sm.win_s[1];
    const bool use_m = v_m >= v_p;
    const float feat_gain = use_m ? v_m : v_p;
    const int t = use_m ? sm.win_t[0] : sm.win_t[1];
    const float lg = use_m ? sm.lm[0][t] : sm.lp[0][t];
    const float lh = use_m ? sm.lm[1][t] : sm.lp[1][t];
    const float lc = use_m ? sm.lm[2][t] : sm.lp[2][t];
    const bool valid = isfinite(feat_gain) && fmask > 0.f;
    const float score =
        valid ? (feat_gain - min_gain_shift) * penalty : -INFINITY;
    const bool dleft = use_m && !(nb <= 2 && miss == LTT_MISSING_NAN);
    o[0] = score;
    o[1] = (float)t;
    o[2] = lg;
    o[3] = lh;
    o[4] = lc;
    o[5] = dleft ? 1.f : 0.f;
    o[6] = out_c(lg, lh, p, L.cmin, L.cmax);
    o[7] = out_c(L.pg - lg, ph_eps - lh, p, L.cmin, L.cmax);
  }
  __syncthreads();  // the shared planes are reused by the next call
  clock_at<kClock>(clk, 4);
}

}  // namespace ltt
