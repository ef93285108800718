// Device code of the split bookkeeping on the merged state, shared by
// both fused split steps (split_step_segment.cu, split_step_leaf.cu):
// reading the split site from S, deriving the two children's sums and
// monotone bounds, and writing both children's S columns, the T column
// with the parent-pointer fixup, and k + 1. The arithmetic repeats
// lightgbm_tpu_torch/learner/split_step.py (split_step_host) in float32,
// compiled with -fmad=false, so the kernels and the host bookkeeping
// write the same bits.
//
// Layouts: S [Ks, L] f32 and T [9, L - 1] f32 are the JAX package's
// merged StatePack (lightgbm_tpu_torch/learner/split_step.py
// make_grow_pack), int rows as f32 bit patterns (__float_as_int, never
// a conversion). The int rows start with a layout prefix of `si0` rows:
// the segment layout's leaf_begin, leaf_cnt (si0 = 2), none for the
// leaf layout (si0 = 0). The helpers take the kernel's own argument
// struct, which carries k, S, T, imeta, table, big_l, F, has_mono, nf
// (float rows of S), si0, max_depth and p.
#pragma once

#include <math.h>

#include "common.cuh"
#include "scan_core.cuh"

namespace ltt {

// imeta columns (split_step_cuda.pack_meta_tables)
constexpr int IM_NBINS = 0, IM_MISS = 1, IM_DEFBIN = 2, IM_MONO = 4;
constexpr int IM_COLS = 8;
// float rows of S; leaf_cmin/leaf_cmax are carried only with monotone
// constraints, then leaf_value
constexpr int S_LEAF_G = 0, S_LEAF_H = 1, S_LEAF_C = 2, S_BS_GAIN = 3,
              S_BS_LG = 4, S_BS_LH = 5, S_BS_LC = 6, S_BS_LOUT = 7,
              S_BS_ROUT = 8, S_CMIN = 9, S_CMAX = 10;
// int rows of S after the nf float rows and the si0 prefix rows
constexpr int SI_FEAT = 0, SI_THR = 1, SI_DLEFT = 2, SI_ISCAT = 3,
              SI_REF_NODE = 4, SI_REF_SIDE = 5, SI_DEPTH = 6;
constexpr int SI_ROWS = 7;
// the segment layout's prefix rows
constexpr int SI_BEGIN = 0, SI_CNT = 1;
// rows of T
constexpr int T_GAIN = 0, T_IVALUE = 1, T_IWEIGHT = 2, T_ICOUNT = 3,
              T_FEAT = 4, T_THR = 5, T_DTYPE = 6, T_LEFT = 7, T_RIGHT = 8;

struct Site {
  int k, leaf, go;
  float g, h, c, gain, lg, lh, lc, lout, rout, cmin, cmax;
  int begin, cnt, feat, thr, dleft, ref_node, ref_side, depth;
};

// the (smaller, other) children of the split, in storage order a, b
struct Pair {
  bool small_left;
  Leaf a, b;  // scan inputs: g, h, c, cmin, cmax
  float out_a, out_b;
};

template <class A>
__device__ __forceinline__ float s_at(const A& a, int row, int leaf) {
  return a.S[(size_t)row * a.big_l + leaf];
}

// int row `row` of the layout (prefix rows first)
template <class A>
__device__ __forceinline__ int s_int(const A& a, int row, int leaf) {
  return __float_as_int(s_at(a, a.nf + row, leaf));
}

__device__ __forceinline__ bool takes(float v, int i, float best, int bi) {
  return v > best || (v == best && i < bi);
}

// Whole block: the split site into s (shared): the first-index argmax
// of the open leaves' bs_gain, the grow loop's condition (k < L and
// best open gain > 0), and the leaf's column.
template <class A>
__device__ void read_site(const A& a, Site& s, float* red_v, int* red_i) {
  const int L = a.big_l;
  const int k = *a.k;
  const int kk = min(k, L);
  const float* gain = a.S + (size_t)S_BS_GAIN * L;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = threadIdx.x; j < kk; j += blockDim.x)
    if (takes(gain[j], j, best, bi)) {
      best = gain[j];
      bi = j;
    }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
    if (takes(v2, i2, best, bi)) {
      best = v2;
      bi = i2;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      if (takes(red_v[w], red_i[w], best, bi)) {
        best = red_v[w];
        bi = red_i[w];
      }
    s.k = k;
    s.leaf = bi;
    s.go = k < L && best > 0.f;
    if (s.go) {
      const int p = a.si0;
      s.g = s_at(a, S_LEAF_G, bi);
      s.h = s_at(a, S_LEAF_H, bi);
      s.c = s_at(a, S_LEAF_C, bi);
      s.gain = s_at(a, S_BS_GAIN, bi);
      s.lg = s_at(a, S_BS_LG, bi);
      s.lh = s_at(a, S_BS_LH, bi);
      s.lc = s_at(a, S_BS_LC, bi);
      s.lout = s_at(a, S_BS_LOUT, bi);
      s.rout = s_at(a, S_BS_ROUT, bi);
      s.cmin = a.has_mono ? s_at(a, S_CMIN, bi) : -INFINITY;
      s.cmax = a.has_mono ? s_at(a, S_CMAX, bi) : INFINITY;
      s.begin = p ? s_int(a, SI_BEGIN, bi) : 0;
      s.cnt = p ? s_int(a, SI_CNT, bi) : 0;
      s.feat = s_int(a, p + SI_FEAT, bi);
      s.thr = s_int(a, p + SI_THR, bi);
      s.dleft = s_int(a, p + SI_DLEFT, bi);
      s.ref_node = s_int(a, p + SI_REF_NODE, bi);
      s.ref_side = s_int(a, p + SI_REF_SIDE, bi);
      s.depth = s_int(a, p + SI_DEPTH, bi);
    }
  }
  __syncthreads();
}

// child sums, monotone bounds (monotone_constraints.hpp:44) and the
// (smaller, other) order, as learner/split_step.py computes them
template <class A>
__device__ __forceinline__ Pair derive_pair(const A& a, const Site& s) {
  Pair q;
  const float rg = s.g - s.lg, rh = s.h - s.lh, rc = s.c - s.lc;
  q.small_left = s.lc <= rc;
  float cmin_l = s.cmin, cmax_l = s.cmax, cmin_r = s.cmin, cmax_r = s.cmax;
  if (a.has_mono) {
    const int mono = a.imeta[s.feat * IM_COLS + IM_MONO];
    const float mid = (s.lout + s.rout) * 0.5f;
    if (mono < 0) {
      cmin_l = fmaxf(s.cmin, mid);
      cmax_r = fminf(s.cmax, mid);
    }
    if (mono > 0) {
      cmax_l = fminf(s.cmax, mid);
      cmin_r = fmaxf(s.cmin, mid);
    }
  }
  const Leaf left{s.lg, s.lh, s.lc, cmin_l, cmax_l};
  const Leaf right{rg, rh, rc, cmin_r, cmax_r};
  q.a = q.small_left ? left : right;
  q.b = q.small_left ? right : left;
  q.out_a = q.small_left ? s.lout : s.rout;
  q.out_b = q.small_left ? s.rout : s.lout;
  return q;
}

// One warp: the best feature of a scan table [F, 8] (assemble_split: the
// first index of the largest score, as a loop from feature 0 taking only
// a strictly larger score finds it; a NaN never wins, and a NaN first
// score keeps feature 0), every lane walking its own features, then a
// warp argmax; to every lane. The table rows come from other blocks of
// this launch: read from L2.
__device__ __forceinline__ int warp_best_feature(const float* tab, int F) {
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = threadIdx.x & 31; j < F; j += 32) {
    const float v = __ldcg(tab + j * 8);
    if (takes(v, j, best, bi)) {
      best = v;
      bi = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
    if (takes(v2, i2, best, bi)) {
      best = v2;
      bi = i2;
    }
  }
  return isnan(__ldcg(tab)) ? 0 : bi;
}

// One child's S column from its scan table [F, 8] (assemble_split: bi,
// the first-index argmax of the score column, from warp_best_feature);
// begin/cnt fill the segment layout's prefix rows.
template <class A>
__device__ void write_child(const A& a, int idx, const float* tab,
                           const Leaf& ch, float out, int side, int begin,
                           int cnt, int node, int depth, bool blocked,
                           int bi) {
  // the table rows come from other blocks of this launch: read from L2
  float r[8];
  for (int i = 0; i < 8; ++i) r[i] = __ldcg(tab + bi * 8 + i);
  const int L = a.big_l;
  float* S = a.S;
  S[S_LEAF_G * L + idx] = ch.pg;
  S[S_LEAF_H * L + idx] = ch.ph;
  S[S_LEAF_C * L + idx] = ch.pc;
  S[S_BS_GAIN * L + idx] = blocked ? -INFINITY : r[0];
  S[S_BS_LG * L + idx] = r[2];
  S[S_BS_LH * L + idx] = r[3] - kEps;
  S[S_BS_LC * L + idx] = r[4];
  S[S_BS_LOUT * L + idx] = r[6];
  S[S_BS_ROUT * L + idx] = r[7];
  if (a.has_mono) {
    S[S_CMIN * L + idx] = ch.cmin;
    S[S_CMAX * L + idx] = ch.cmax;
  }
  S[(a.nf - 1) * L + idx] = out;  // leaf_value, the last float row
  const int prefix[2] = {begin, cnt};
  for (int i = 0; i < a.si0; ++i)
    S[(size_t)(a.nf + i) * L + idx] = __int_as_float(prefix[i]);
  const int ints[SI_ROWS] = {bi, (int)r[1], r[5] > 0.5f ? 1 : 0, 0,
                             node, side, depth};
  for (int i = 0; i < SI_ROWS; ++i)
    S[(size_t)(a.nf + a.si0 + i) * L + idx] = __int_as_float(ints[i]);
}

// One thread: both children's S columns from a.table ([2, F, 8], a then
// b; bi_a/bi_b their best features), the node's T column and the
// parent-pointer fixup, then k + 1. (begin, cnt) of each child fill the
// segment layout's prefix rows.
template <class A>
__device__ void finish(const A& a, const Site& s, const Pair& q,
                       int begin_a, int cnt_a, int begin_b, int cnt_b,
                       int bi_a, int bi_b) {
  const int leaf = s.leaf, nw = s.k, node = s.k - 1;
  const int depth = s.depth + 1;
  const bool blocked = a.max_depth > 0 && depth >= a.max_depth;
  const int idx_a = q.small_left ? leaf : nw;
  const int idx_b = q.small_left ? nw : leaf;
  const int side_a = q.small_left ? 0 : 1;
  write_child(a, idx_a, a.table, q.a, q.out_a, side_a, begin_a, cnt_a, node,
              depth, blocked, bi_a);
  write_child(a, idx_b, a.table + (size_t)a.F * 8, q.b, q.out_b, 1 - side_a,
              begin_b, cnt_b, node, depth, blocked, bi_b);
  const int L1 = a.big_l - 1;
  float* T = a.T;
  T[T_GAIN * L1 + node] = s.gain;
  T[T_IVALUE * L1 + node] = out_nc(s.g, s.h + 2e-15f, a.p);
  T[T_IWEIGHT * L1 + node] = s.h;
  T[T_ICOUNT * L1 + node] = s.c;
  T[T_FEAT * L1 + node] = __int_as_float(s.feat);
  T[T_THR * L1 + node] = __int_as_float(s.thr);
  T[T_DTYPE * L1 + node] = __int_as_float(s.dleft ? 2 : 0);
  T[T_LEFT * L1 + node] = __int_as_float(~leaf);
  T[T_RIGHT * L1 + node] = __int_as_float(~nw);
  if (s.ref_node >= 0)
    T[(s.ref_side == 0 ? T_LEFT : T_RIGHT) * L1 + s.ref_node] =
        __int_as_float(node);
  *a.k = s.k + 1;
}

// The last block of a launch, all its threads: warps 0 and 1 find the
// two children's best features, then thread 0 writes the state
// (finish). red: shared int[2].
template <class A>
__device__ void finish_block(const A& a, const Site& s, const Pair& q,
                             int begin_a, int cnt_a, int begin_b, int cnt_b,
                             int* red) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int bi = warp_best_feature(a.table + (size_t)warp * a.F * 8, a.F);
    if ((threadIdx.x & 31) == 0) red[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    finish(a, s, q, begin_a, cnt_a, begin_b, cnt_b, red[0], red[1]);
}

// Blocks per SM and grid size of a cooperative kernel at this block
// size and dynamic shared memory (per_sm * SMs, so every block is
// resident); the caller caches the result per device.
template <class K>
int cooperative_grid(K kernel, int threads, size_t smem, int* per_sm_out,
                     int* grid_out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *per_sm_out = per_sm;
  *grid_out = per_sm * sms;
  return 0;
}

}  // namespace ltt
