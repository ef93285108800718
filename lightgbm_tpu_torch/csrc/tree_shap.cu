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
//  * tree_shap_bins: the host packs the paths of at most 32 elements
//    into bins of 32 lanes, first-fit decreasing by length
//    (ops/tree_shap_cuda.py:pack_bins), a path on consecutive lanes, an
//    element a lane, and lays each lane's data out once a model: its
//    position, its path's first lane and length, its feature, zero
//    fraction, leaf value and class, and its one-fraction test -- the
//    interval (lo, hi] of its numerical nodes and the answer for a
//    missing value, or (a categorical node, mixed missing codes) the
//    element's node list. A warp owns `rows` rows (their phi in shared
//    memory, or in their out rows when k (F + 1) is too wide; the wrapper
//    picks `rows` so that a block's phi stays small and many warps fit an
//    SM) and walks every bin in order, a bin's lane data held in
//    registers across its rows. For a row, each lane tests its element,
//    the path weights are extended in float64 (lane i of a path holds
//    weight i; its left neighbour's by shuffle, element d's zero fraction
//    from the warp's shared copy of the bin's), and each lane takes its
//    own unwound sum reading its path's weights from the warp's shared
//    copy; the loops run to the bin's longest path. No loop divides: the
//    ratios (d - i) / (d + 1), i / (d + 1), (D + 1) / (j + 1),
//    (D - j) / (D + 1) and (D + 1) / (D - j) come from tables the host
//    computes once (ops/tree_shap_cuda.py:shap_tables), 1 / zero is taken
//    once a bin. The lanes of a bin that add to one (class, feature) slot
//    leave their values in shared memory for the lowest of them, which
//    adds its own, then theirs in lane order, and adds the sum once: no
//    two lanes add to a slot at once, and a slot's sum runs over the bins
//    in order, then the lanes of a bin in order, the same on every run.
//    Each class's expected value goes in its last slot.
//  * tree_shap_long: the paths of more than 32 elements (F >= 32): a
//    block takes a row and walks them, one element a thread, the weights
//    in shared memory with a block barrier a step; it adds into the out
//    row the bin kernel wrote before it on the same stream.
//
// What bounds it on the H100: float64 operations. A row and a path of
// D + 1 elements cost ~7 D (D + 3) / 2 operations to extend and ~8 D^2
// for the unwound sums, against 8 (F + k (F + 1)) bytes a row; the
// row's bytes are negligible. The bin kernel keeps most lanes busy
// (short paths share a warp) and issues no float64 division in its
// loops; its cost is the float64 multiplies and the dependent steps of
// each extend and unwound loop, and the shared-memory round trips
// between them.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block of tree_shap_bins
constexpr int kMaxRows = 16;  // rows a warp of tree_shap_bins, at most
constexpr int kMaxSmem = 96 * 1024;  // phi rows in shared memory, at most
// tree_shap_bins' static shared memory (wsh), which counts against the
// 48 KB a launch may take without opting in.
constexpr int kStaticSmem = kWarps * 3 * 32 * 8;
constexpr int kTab = 33;      // the ratio tables' side (d, D <= 32)
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

// A bin lane's ints (lint [bins * 32][8]): meta (position | first lane
// << 8 | path length << 16; 0 for an idle lane), feature (-1: the bias
// element), flags (bits 0-1 missing code, 2 one when missing, 3 the node
// list, 4 the lane adds its peers' sum), element, class, peers (the
// lanes after it that add to the same slot), 2 unused; doubles (ldbl
// [bins * 32][4]): zero fraction, lo, hi, leaf value; per bin (blen
// [bins]): its longest path. The ratio tables (tabs, float64): ext
// [kTab][kTab][2] = ((d - i) / (d + 1), i / (d + 1)), then unw
// [kTab][kTab][4] = ((D + 1) / (j + 1), (D - j) / (D + 1),
// (D + 1) / (D - j), 0).
constexpr int kFlagOneMissing = 4;
constexpr int kFlagGeneral = 8;
constexpr int kFlagLeader = 16;

// kTimed: lane 0 of every warp adds its cycles of the bins' loads, the
// one fractions, the extends, the unwound sums, the peer sums and phi
// adds, and the phi zeroing and write-out, and its (row, bin) steps, into
// times[warp] (chip_profile.py --shap-phases).
template <bool kTimed>
__global__ void __launch_bounds__(kWarps * 32)
    tree_shap_bins(const double* __restrict__ x, long long n, int F,
                   Model m, const int* __restrict__ lint,
                   const double* __restrict__ ldbl,
                   const int* __restrict__ blen, int nbins,
                   const double* __restrict__ tabs, int rows,
                   double* __restrict__ out, int use_smem,
                   long long* times) {
  extern __shared__ double sh[];
  __shared__ double wsh[kWarps][3][32];  // a warp's zeros, weights, values
  static_assert(sizeof(wsh) == kStaticSmem, "kStaticSmem");
  unsigned long long t_last = 0, acc[7] = {0, 0, 0, 0, 0, 0, 0};
  if constexpr (kTimed) t_last = clock64();
  auto lap = [&](int i) {
    if constexpr (kTimed) {
      const unsigned long long now = clock64();
      acc[i] += now - t_last;
      t_last = now;
    }
  };
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wid = (long long)blockIdx.x * kWarps + warp;
  const long long r0 = wid * rows;
  if (r0 >= n) return;
  const int nr = (int)min((long long)rows, n - r0);
  const int stride = m.k * (F + 1);
  double* phi = use_smem ? sh + (size_t)warp * rows * stride
                         : out + r0 * stride;
  double* szero = wsh[warp][0];
  double* spw = wsh[warp][1];
  double* sv = wsh[warp][2];
  const double2* ext = reinterpret_cast<const double2*>(tabs);
  const double2* unw =
      reinterpret_cast<const double2*>(tabs + 2 * kTab * kTab);
  for (int i = lane; i < nr * stride; i += 32) phi[i] = 0.0;
  __syncwarp();
  lap(5);
  for (int bi = 0; bi < nbins; ++bi) {
    const int4* li = reinterpret_cast<const int4*>(lint) + (bi * 32 + lane) * 2;
    const double2* ld =
        reinterpret_cast<const double2*>(ldbl) + (bi * 32 + lane) * 2;
    const int4 ia = __ldg(li), ib = __ldg(li + 1);
    const double2 da = __ldg(ld), db = __ldg(ld + 1);
    const int maxlen = __ldg(blen + bi);
    const int r = ia.x & 0xff, s = (ia.x >> 8) & 0xff,
              len = (ia.x >> 16) & 0xff;
    const int feat = ia.y, flags = ia.z, elem = ia.w;
    const unsigned peers = (unsigned)ib.y;
    const double zero = da.x, lo = da.y, hi = db.x, val = db.y;
    const double invz = 1.0 / zero;
    const int D = len - 1;
    const int tgt = ib.x * (F + 1) + feat;
    const bool adds = (flags & kFlagLeader) != 0;
    const int miss = flags & 3;
    const double2* urow = unw + 2 * kTab * max(D, 0);
    __syncwarp();  // the last bin's reads of szero are done
    szero[lane] = zero;
    __syncwarp();
    lap(0);
    for (int rr = 0; rr < nr; ++rr) {
      const double* row = x + (r0 + rr) * F;
      double one = 1.0;
      if (feat >= 0) {
        if (flags & kFlagGeneral) {
          one = one_fraction(m, elem, row);
        } else {
          double v = __ldg(row + feat);
          const bool nan = isnan(v);
          if (nan && miss != LTT_MISSING_NAN) v = 0.0;
          const bool is_missing = miss == LTT_MISSING_ZERO
                                      ? fabs(v) <= 1e-35
                                      : (miss == LTT_MISSING_NAN && nan);
          one = is_missing ? ((flags & kFlagOneMissing) ? 1.0 : 0.0)
                           : ((v > lo && v <= hi) ? 1.0 : 0.0);
        }
      }
      const unsigned ones = __ballot_sync(kFull, len > 0 && one != 0.0);
      lap(1);
      double pw = r == 0 ? 1.0 : 0.0;
      for (int d = 1; d < maxlen; ++d) {
        const double left = __shfl_up_sync(kFull, pw, 1);
        if (d < len && r <= d) {
          const double2 q = __ldg(ext + d * kTab + r);
          const double a = r < d ? szero[s + d] * pw * q.x : 0.0;
          const double b =
              r >= 1 && ((ones >> (s + d)) & 1u) ? left * q.y : 0.0;
          pw = a + b;
        }
      }
      spw[lane] = pw;
      __syncwarp();
      lap(2);
      double next_one = spw[min(s + max(D, 0), 31)];
      double total = 0.0;
      for (int j = maxlen - 2; j >= 0; --j) {
        if (j < D) {
          const double pwj = spw[s + j];
          const double2 u = __ldg(urow + 2 * j);
          if (one != 0.0) {
            const double tmp = next_one * u.x;
            total += tmp;
            next_one = pwj - tmp * zero * u.y;
          } else {
            total += pwj * invz * __ldg(urow + 2 * j + 1).x;
          }
        }
      }
      lap(3);
      const double v = len > 0 && r >= 1 ? total * (one - zero) * val : 0.0;
      sv[lane] = v;
      __syncwarp();  // every value is in; spw's reads are done
      if (adds) {
        double sum = v;
        for (unsigned mm = peers; mm; mm &= mm - 1u) sum += sv[__ffs(mm) - 1];
        phi[rr * stride + tgt] += sum;
      }
      __syncwarp();
      lap(4);
      if constexpr (kTimed) acc[6] += 1;
    }
  }
  for (int i = lane; i < nr * m.k; i += 32)
    phi[(i / m.k) * stride + (i % m.k) * (F + 1) + F] = m.expected[i % m.k];
  __syncwarp();
  if (use_smem)
    for (int i = lane; i < nr * stride; i += 32) out[r0 * stride + i] = phi[i];
  lap(5);
  if constexpr (kTimed) {
    if (lane == 0)
      for (int i = 0; i < 7; ++i) times[wid * 7 + i] = (long long)acc[i];
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

// Launches tree_shap_bins with `smem` bytes of phi rows, opting in past
// the default 48 KB where the static and the dynamic bytes need it.
template <bool kTimed>
cudaError_t launch_bins(unsigned blocks, size_t smem, cudaStream_t stream,
                        const double* x, long long n, int F, const Model& m,
                        const int* lint, const double* ldbl, const int* blen,
                        int nbins, const double* tabs, int rows, double* out,
                        int use_smem, long long* times) {
  cudaError_t err;
  if (smem + kStaticSmem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           tree_shap_bins<kTimed>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return err;
  tree_shap_bins<kTimed><<<blocks, kWarps * 32, smem, stream>>>(
      x, n, F, m, lint, ldbl, blen, nbins, tabs, rows, out, use_smem, times);
  return cudaGetLastError();
}

}  // namespace

// x [n, F] f64 row-major; the model's paths (ops/tree_shap_cuda.py
// shap_paths) for the node lists and the long paths; the short paths'
// bins (pack_bins, bin_lanes): lint [nbins * 32 * 8] i32, ldbl [nbins *
// 32 * 4] f64, blen [nbins] i32; tabs: the ratio tables (shap_tables);
// rows: rows a warp (1 to kMaxRows); long_paths: the ids of the paths of
// more than 32 elements; out [n, k (F + 1)] f64, every element written.
// use_smem: phi rows in shared memory (smem_bytes = kWarps rows k (F + 1)
// 8 <= kMaxSmem), else in out; long_threads: a multiple of 32 at least
// the longest path; long_blocks: the long kernel's grid; times: null, or
// int64 [warps, 7] for the bin kernel's timed instantiation (warps =
// ceil(n / rows), rounded up to kWarps).
LTT_EXPORT int ltt_tree_shap(
    const double* x, long long n, int F, const int* nfeat,
    const double* nthr, const int* nflags, const int* ncat_off,
    const int* ncat_len, const unsigned* cats, const int* pbegin,
    const double* pvalue, const int* pcls, const int* efeat,
    const double* ezero, const int* ecbegin, const int* cnode,
    const int* cleft, const double* expected, int k, const int* lint,
    const double* ldbl, const int* blen, int nbins, const double* tabs,
    int rows, const int* long_paths, int num_long, int long_threads,
    double* out, int use_smem, int smem_bytes, int long_blocks,
    long long* times, cudaStream_t stream) {
  if (n < 0 || F < 0 || k < 1 || nbins < 0 || num_long < 0 || rows < 1 ||
      rows > kMaxRows ||
      (num_long > 0 && (long_threads < 32 || long_threads > 1024 ||
                        long_blocks < 1)) ||
      (use_smem && (smem_bytes < kWarps * rows * k * (F + 1) * 8 ||
                    smem_bytes > kMaxSmem)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Model m{nfeat,  nthr,   nflags, ncat_off, ncat_len, cats,
                pbegin, pvalue, pcls,   efeat,    ezero,    ecbegin,
                cnode,  cleft,  expected, k};
  const long long rows_a_block = (long long)kWarps * rows;
  const unsigned blocks = (unsigned)((n + rows_a_block - 1) / rows_a_block);
  const size_t smem = use_smem ? (size_t)smem_bytes : 0;
  cudaError_t err = times
      ? launch_bins<true>(blocks, smem, stream, x, n, F, m, lint, ldbl,
                          blen, nbins, tabs, rows, out, use_smem, times)
      : launch_bins<false>(blocks, smem, stream, x, n, F, m, lint, ldbl,
                           blen, nbins, tabs, rows, out, use_smem, nullptr);
  if (err != cudaSuccess) return (int)err;
  if (num_long == 0) return 0;
  tree_shap_long<<<long_blocks, long_threads,
                   3 * long_threads * sizeof(double), stream>>>(
      x, n, F, m, long_paths, num_long, out);
  return (int)cudaGetLastError();
}
