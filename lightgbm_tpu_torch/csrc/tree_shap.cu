// TreeSHAP contributions of a tree ensemble on Hopper.
//
// Replaces the host TreeSHAP of the JAX package
// (lightgbm_tpu/native/treeshap.cpp, called from
// lightgbm_tpu/predictor.py:503 _predict_contrib; Python twin _tree_shap
// :593), the reference's recursion (src/io/tree.cpp:631-737). No TPU
// kernel lies on that path: the JAX package computes SHAP values on the
// host.
//
// Design: GPUTreeShap (Mitchell, Frank, Wilson, Holmes, Fouche, PeerJ CS
// 2022). The recursion keeps an arena of (D + 1)(D + 2) / 2 path
// elements a row, too large for a thread at the depth of a 255-leaf
// leaf-wise tree, so the host (ops/tree_shap_cuda.py:shap_paths) splits
// every tree once into its root-to-leaf paths, with a feature's repeated
// nodes merged into one element (the unwind of the recursion): its zero
// fraction is the product of the cover ratios along the path, its one
// fraction, per row, the AND of the row's decisions at its nodes
// (NumericalDecision / CategoricalDecision, as predictor.py decides). A
// path's contribution to feature f is then the Shapley weight of its
// element (extend over all elements, then the element's unwound sum)
// times (one - zero) times the leaf value, exactly the recursion's sum
// at the leaf.
//
//  * tree_shap_warp: a warp takes a row and walks every path of at most
//    32 elements, 32 / group paths at a time, a path to a group of
//    `group` lanes (the longest path rounded up to a power of two), one
//    element a lane: the lane evaluates its element's one fraction, the
//    path weights are extended in float64 with shuffles inside the group
//    (lane i of the group holds weight i), and each lane takes its own
//    unwound sum, reading the group's weights by broadcast. A path's
//    elements have distinct features, but the paths of a set may share
//    some, so the groups add their contributions into the row's phi in
//    turn, with no atomics; the row's phi lives in shared memory (or in
//    its out row when k (F + 1) is too wide) and is written once, with
//    each class's expected value in its last slot. A row's sums are in
//    path order, the same on every run.
//  * tree_shap_long: the paths of more than 32 elements (F >= 32): a
//    block takes a row and walks them, one element a thread, the weights
//    in shared memory with a block barrier a step; it adds into the out
//    row the warp kernel wrote before it on the same stream.
//
// What bounds it on the H100: float64 operations. A row and a path of
// D + 1 elements cost ~7 D (D + 3) / 2 operations to extend and ~8 D^2
// for the unwound sums, against 8 (F + k (F + 1)) bytes a row; at a
// 255-leaf tree's D ~ 5-20 that is ~300-4,000 float64 operations a
// path a row, so the row's bytes are negligible. A lane an element of
// a group sized by the longest path leaves the lanes of shorter paths
// idle; sorting paths by length into groups is the next lever.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block of tree_shap_warp
constexpr unsigned kFull = 0xffffffffu;

struct Model {
  const int* nfeat;          // [nodes] the node's feature
  const double* nthr;        // [nodes] its threshold
  const int* nflags;         // bit 0 categorical, 1 default left, 2-3 miss
  const int* ncat_off;       // [nodes] into cats
  const int* ncat_len;       // [nodes] words of its left categories
  const unsigned* cats;      // category bitsets
  const int* pbegin;         // [paths + 1] into the elements
  const double* pvalue;      // [paths] leaf value
  const int* pcls;           // [paths] class
  const int* efeat;          // [elements] feature, -1 for the bias
  const double* ezero;       // [elements] zero fraction
  const int* ecbegin;        // [elements + 1] into the conditions
  const int* cnode;          // [conditions] node
  const int* cleft;          // [conditions] 1: the path goes left
  const double* expected;    // [k] expected value of each class
  int k;
};

// Does the row go left at node g (predictor.py predict_leaf_index)?
__device__ __forceinline__ bool go_left(const Model& m, int g,
                                        const double* row) {
  double v = row[m.nfeat[g]];
  const int flags = m.nflags[g];
  const int miss = (flags >> 2) & 3;
  const bool nan = isnan(v);
  if (nan && miss != LTT_MISSING_NAN) v = 0.0;
  if (flags & 1) {
    if (isnan(v)) return false;
    const double c = trunc(v);
    if (c < 0.0 || c >= 32.0 * m.ncat_len[g]) return false;
    const int ci = (int)c;
    return (m.cats[m.ncat_off[g] + (ci >> 5)] >> (ci & 31)) & 1u;
  }
  const bool is_missing = miss == LTT_MISSING_ZERO
                              ? fabs(v) <= 1e-35
                              : (miss == LTT_MISSING_NAN && nan);
  return is_missing ? (flags & 2) != 0 : v <= m.nthr[g];
}

// 1 when the row takes the path's side at each node of element e.
__device__ __forceinline__ double one_fraction(const Model& m, int e,
                                               const double* row) {
  for (int c = m.ecbegin[e]; c < m.ecbegin[e + 1]; ++c)
    if (go_left(m, m.cnode[c], row) != (m.cleft[c] != 0)) return 0.0;
  return 1.0;
}

// ExtendPath's update of weight i when element d joins (tree.cpp:
// 631-643): old weights w_i (own) and w_{i-1} (left), i <= d.
__device__ __forceinline__ double extended(double w, double left, int i,
                                           int d, double zd, double od) {
  const double a = i < d ? zd * w * (double)(d - i) / (double)(d + 1) : 0.0;
  const double b =
      i >= 1 ? od * left * (double)i / (double)(d + 1) : 0.0;
  return a + b;
}

// One step of UnwoundPathSum (tree.cpp:670-688), step j of depth D, for
// an element with fractions (zero, one).
__device__ __forceinline__ void unwound_step(double pwj, int j, int D,
                                             double zero, double one,
                                             double* next_one,
                                             double* total) {
  if (one != 0.0) {
    const double tmp = *next_one * (double)(D + 1) / ((double)(j + 1) * one);
    *total += tmp;
    *next_one = pwj - tmp * zero * (double)(D - j) / (double)(D + 1);
  } else {
    *total += (pwj / zero) / ((double)(D - j) / (double)(D + 1));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    tree_shap_warp(const double* __restrict__ x, long long n, int F,
                   Model m, const int* __restrict__ paths, int num_paths,
                   int group, double* __restrict__ out, int use_smem) {
  extern __shared__ double sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / group;      // the lane's path in the warp's set
  const int r = lane % group;      // its element in that path
  const int per = 32 / group;      // paths a warp takes at once
  const int stride = m.k * (F + 1);
  const long long warps_total = (long long)gridDim.x * kWarps;
  for (long long row_i = (long long)blockIdx.x * kWarps + warp; row_i < n;
       row_i += warps_total) {
    const double* row = x + row_i * F;
    double* phi =
        use_smem ? sh + (size_t)warp * stride : out + row_i * stride;
    for (int i = lane; i < stride; i += 32) phi[i] = 0.0;
    __syncwarp();
    for (int q0 = 0; q0 < num_paths; q0 += per) {
      const int q = q0 + g;
      const bool has = q < num_paths;
      const int p = has ? paths[q] : 0;
      const int b = m.pbegin[p];
      const int len = has ? m.pbegin[p + 1] - b : 0;  // <= group
      const bool active = r < len;
      const int e = b + (active ? r : 0);
      const double zero = active ? m.ezero[e] : 0.0;
      const double one = active ? one_fraction(m, e, row) : 0.0;
      int maxlen = len;  // the warp's longest path: its loops' bound
      for (int o = 16; o > 0; o >>= 1)
        maxlen = max(maxlen, __shfl_xor_sync(kFull, maxlen, o));
      double pw = r == 0 ? 1.0 : 0.0;
      for (int d = 1; d < maxlen; ++d) {
        const double zd = __shfl_sync(kFull, zero, d, group);
        const double od = __shfl_sync(kFull, one, d, group);
        const double left = __shfl_up_sync(kFull, pw, 1, group);
        if (d < len && r <= d) pw = extended(pw, left, r, d, zd, od);
      }
      const int D = len - 1;
      double next_one = __shfl_sync(kFull, pw, max(D, 0), group);
      double total = 0.0;
      for (int j = maxlen - 2; j >= 0; --j) {
        const double pwj = __shfl_sync(kFull, pw, j, group);
        if (j < D) unwound_step(pwj, j, D, zero, one, &next_one, &total);
      }
      // the set's paths may share features: their adds take turns
      for (int t = 0; t < per; ++t) {
        if (g == t && active && r >= 1)
          phi[m.pcls[p] * (F + 1) + m.efeat[e]] +=
              total * (one - zero) * m.pvalue[p];
        __syncwarp();
      }
    }
    for (int c = lane; c < m.k; c += 32) phi[c * (F + 1) + F] = m.expected[c];
    __syncwarp();
    if (use_smem)
      for (int i = lane; i < stride; i += 32)
        out[row_i * stride + i] = phi[i];
    __syncwarp();
  }
}

__global__ void tree_shap_long(const double* __restrict__ x, long long n,
                               int F, Model m,
                               const int* __restrict__ paths, int num_paths,
                               double* __restrict__ out) {
  extern __shared__ double s[];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  double* spw = s;          // [T] path weights
  double* sz = s + T;       // [T] zero fractions
  double* so = s + 2 * T;   // [T] one fractions
  const int stride = m.k * (F + 1);
  for (long long r = blockIdx.x; r < n; r += gridDim.x) {
    const double* row = x + r * F;
    double* phi = out + r * stride;
    for (int q = 0; q < num_paths; ++q) {
      const int p = paths[q];
      const int b = m.pbegin[p];
      const int len = m.pbegin[p + 1] - b;  // <= T
      const bool active = t < len;
      const int e = b + (active ? t : 0);
      const double zero = active ? m.ezero[e] : 0.0;
      const double one = active ? one_fraction(m, e, row) : 0.0;
      sz[t] = zero;
      so[t] = one;
      spw[t] = t == 0 ? 1.0 : 0.0;
      __syncthreads();
      for (int d = 1; d < len; ++d) {
        const double w = spw[t];
        const double left = t >= 1 ? spw[t - 1] : 0.0;
        const double zd = sz[d], od = so[d];
        __syncthreads();
        if (t <= d) spw[t] = extended(w, left, t, d, zd, od);
        __syncthreads();
      }
      const int D = len - 1;
      double next_one = spw[D];
      double total = 0.0;
      for (int j = D - 1; j >= 0; --j)
        unwound_step(spw[j], j, D, zero, one, &next_one, &total);
      if (active && t >= 1)
        phi[m.pcls[p] * (F + 1) + m.efeat[e]] +=
            total * (one - zero) * m.pvalue[p];
      __syncthreads();
    }
  }
}

}  // namespace

// x [n, F] f64 row-major; the model's paths (ops/tree_shap_cuda.py
// shap_paths); short_paths / long_paths: the ids of the paths of at most
// and of more than 32 elements; group: a power of two at least the
// longest short path (lanes a path); out [n, k (F + 1)] f64, every element
// written. blocks: the warp kernel's grid (kWarps rows a block at a
// time); use_smem: phi rows in shared memory (smem_bytes = kWarps k
// (F + 1) 8 <= 48 KB), else in out; long_threads: a multiple of 32 at
// least the longest path; long_blocks: the long kernel's grid.
LTT_EXPORT int ltt_tree_shap(
    const double* x, long long n, int F, const int* nfeat,
    const double* nthr, const int* nflags, const int* ncat_off,
    const int* ncat_len, const unsigned* cats, const int* pbegin,
    const double* pvalue, const int* pcls, const int* efeat,
    const double* ezero, const int* ecbegin, const int* cnode,
    const int* cleft, const double* expected, int k,
    const int* short_paths, int num_short, int group,
    const int* long_paths, int num_long, int long_threads, double* out,
    int blocks, int use_smem, int smem_bytes, int long_blocks,
    cudaStream_t stream) {
  if (n < 0 || F < 0 || k < 1 || blocks < 1 || num_short < 0 ||
      group < 1 || group > 32 || (group & (group - 1)) != 0 ||
      num_long < 0 || (num_long > 0 && (long_threads < 32 ||
                                        long_threads > 1024 ||
                                        long_blocks < 1)) ||
      (use_smem && (smem_bytes < kWarps * k * (F + 1) * 8 ||
                    smem_bytes > 48 * 1024)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Model m{nfeat,  nthr,   nflags, ncat_off, ncat_len, cats,
                pbegin, pvalue, pcls,   efeat,    ezero,    ecbegin,
                cnode,  cleft,  expected, k};
  tree_shap_warp<<<blocks, kWarps * 32, use_smem ? smem_bytes : 0,
                   stream>>>(x, n, F, m, short_paths, num_short, group,
                             out, use_smem);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_long == 0) return (int)err;
  tree_shap_long<<<long_blocks, long_threads,
                   3 * long_threads * sizeof(double), stream>>>(
      x, n, F, m, long_paths, num_long, out);
  return (int)cudaGetLastError();
}
