"""Model -> C++ if-else code generation (``task=convert_model``; port
of ``lightgbm_tpu/io/codegen.py``, host-only: for the same model text
the generated source is byte-equal to the JAX package's, whose banner
line it keeps).

Reference analog: ``GBDT::ModelToIfElse``
(src/boosting/gbdt_model_text.cpp:117-299) and the
``convert_model`` / ``convert_model_language`` config params
(include/LightGBM/config.h). The generated translation unit is
self-contained C++ exposing a C ABI:

    GetNumClasses() / GetNumTrees() / GetNumFeatures()
    PredictRaw(const double* features, double* out)   // [num_class]
    Predict(const double* features, double* out)      // + ConvertOutput

so it can be compiled with any C++ compiler (``g++ -shared -fPIC``)
and loaded via ctypes/dlopen with no framework dependency. Decision
semantics are exactly ``Tree::NumericalDecision`` /
``CategoricalDecision`` (include/LightGBM/tree.h:250-300): NaN maps to
0.0 unless the node's missing type is NaN; Zero-missing compares
|v| <= kZeroThreshold; categorical membership tests the raw category
value against the node's bitset.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.tree import kCategoricalMask, kDefaultLeftMask

_PRELUDE = r"""// generated by lightgbm_tpu task=convert_model; do not edit
#include <cmath>
#include <limits>

#if defined(_MSC_VER)
#define LGBM_EXPORT extern "C" __declspec(dllexport)
#else
#define LGBM_EXPORT extern "C" __attribute__((visibility("default")))
#endif

static const double kZeroThreshold = 1e-35;

// missing_type=None: NaN coerces to 0.0 (tree.h:252-254)
static inline bool DecideNone(double raw, double thr) {
  double v = std::isnan(raw) ? 0.0 : raw;
  return v <= thr;
}
// missing_type=Zero: |v| <= kZeroThreshold routes to the default side
static inline bool DecideZero(double raw, double thr, bool default_left) {
  double v = std::isnan(raw) ? 0.0 : raw;
  if (std::fabs(v) <= kZeroThreshold) return default_left;
  return v <= thr;
}
// missing_type=NaN: NaN routes to the default side
static inline bool DecideNan(double raw, double thr, bool default_left) {
  if (std::isnan(raw)) return default_left;
  return raw <= thr;
}
// CategoricalDecision (tree.h:259-267): left iff int(v) is in the set.
// NaN coerces to category 0 unless the node's missing type is NaN
// (tree.h:252-254) — nan_as_zero carries the node's missing type.
static inline bool DecideCat(double raw, const unsigned int* bits,
                             int n_words, bool nan_as_zero) {
  if (std::isnan(raw)) {
    if (!nan_as_zero) return false;
    raw = 0.0;
  }
  int iv = static_cast<int>(raw);
  if (iv < 0 || iv >= n_words * 32) return false;
  return (bits[iv / 32] >> (iv % 32)) & 1U;
}
"""


def _fmt(x: float) -> str:
    x = float(np.float64(x))
    if np.isnan(x):
        return "std::numeric_limits<double>::quiet_NaN()"
    if np.isinf(x):
        sign = "-" if x < 0 else ""
        return f"{sign}std::numeric_limits<double>::infinity()"
    return repr(x)


def _leaf_expr(tree, leaf: int) -> str:
    """Leaf output expression: the constant, or — for linear leaves
    (docs/LinearTrees.md) — ``const + w . x`` with the constant
    fallback when any model feature is NaN. Emitted in double (the
    codegen path is double-precision throughout; the trained f32
    accumulate may differ at rounding level, like the reference's
    compiled predictors)."""
    const = _fmt(tree.leaf_value[leaf])
    if not getattr(tree, "is_linear", False):
        return const
    feats = [int(f) for f in tree.leaf_features[leaf] if f >= 0]
    if not feats:
        return _fmt(tree.leaf_const[leaf])
    coeffs = [float(c) for c in tree.leaf_coeff[leaf][:len(feats)]]
    nan_check = " || ".join(f"std::isnan(a[{f}])" for f in feats)
    lin = " + ".join([_fmt(tree.leaf_const[leaf])]
                     + [f"{_fmt(c)} * a[{f}]"
                        for c, f in zip(coeffs, feats)])
    return f"({nan_check}) ? {const} : ({lin})"


def _emit_tree(tree, idx: int, out: List[str]) -> None:
    if tree.num_leaves <= 1:
        out.append(f"static double PredictTree{idx}(const double*) "
                   f"{{ return {_fmt(tree.leaf_value[0])}; }}\n")
        return

    # categorical bitsets as static arrays, one per categorical node
    cat_names = {}
    for s in range(tree.num_leaves - 1):
        if tree.decision_type[s] & kCategoricalMask:
            cats = np.asarray(tree.cat_threshold[s], np.int64)
            max_cat = int(cats.max(initial=0))
            n_words = max_cat // 32 + 1
            bits = np.zeros(n_words, np.uint32)
            for c in cats:
                if c >= 0:
                    bits[c // 32] |= np.uint32(1) << np.uint32(c % 32)
            name = f"kTree{idx}Cats{s}"
            vals = ", ".join(f"{int(w)}U" for w in bits)
            out.append(f"static const unsigned int {name}[{n_words}] = "
                       f"{{{vals}}};\n")
            cat_names[s] = (name, n_words)

    # explicit stack, not recursion: leaf-wise growth can produce
    # near-linear chains deeper than CPython's recursion limit
    body: List[str] = []
    stack: List[tuple] = [("node", 0, 0)]
    while stack:
        kind, val, depth = stack.pop()
        pad = "  " * (min(depth, 40) + 1)   # cap indent on deep chains
        if kind == "text":
            body.append(val)
            continue
        child = val
        if child < 0:
            body.append(f"{pad}return {_leaf_expr(tree, ~child)};\n")
            continue
        s = child
        f = int(tree.split_feature[s])
        thr = _fmt(tree.threshold[s])
        dl = "true" if tree.decision_type[s] & kDefaultLeftMask \
            else "false"
        if tree.decision_type[s] & kCategoricalMask:
            name, n_words = cat_names[s]
            nz = "false" if int(tree.missing_code[s]) == 2 else "true"
            cond = f"DecideCat(a[{f}], {name}, {n_words}, {nz})"
        else:
            miss = int(tree.missing_code[s])
            if miss == 1:
                cond = f"DecideZero(a[{f}], {thr}, {dl})"
            elif miss == 2:
                cond = f"DecideNan(a[{f}], {thr}, {dl})"
            else:
                cond = f"DecideNone(a[{f}], {thr})"
        body.append(f"{pad}if ({cond}) {{\n")
        stack.append(("text", f"{pad}}}\n", depth))
        stack.append(("node", int(tree.right_child[s]), depth + 1))
        stack.append(("text", f"{pad}}} else {{\n", depth))
        stack.append(("node", int(tree.left_child[s]), depth + 1))
    out.append(f"static double PredictTree{idx}(const double* a) {{\n")
    out.extend(body)
    out.append("}\n")


def _transform_code(objective_str: str, num_class: int) -> str:
    name = objective_str.split(" ")[0] if objective_str else ""
    sigmoid = 1.0
    for tok in objective_str.split()[1:]:
        if tok.startswith("sigmoid:"):
            sigmoid = float(tok.split(":")[1])
    if name in ("binary", "cross_entropy", "multiclassova"):
        return (f"  for (int c = 0; c < {num_class}; ++c)\n"
                f"    out[c] = 1.0 / (1.0 + std::exp(-{_fmt(sigmoid)}"
                " * out[c]));\n")
    if name == "multiclass":
        return ("  double wmax = out[0], wsum = 0.0;\n"
                f"  for (int c = 1; c < {num_class}; ++c)\n"
                "    if (out[c] > wmax) wmax = out[c];\n"
                f"  for (int c = 0; c < {num_class}; ++c)"
                " { out[c] = std::exp(out[c] - wmax); wsum += out[c]; }\n"
                f"  for (int c = 0; c < {num_class}; ++c)"
                " out[c] /= wsum;\n")
    if name in ("poisson", "gamma", "tweedie"):
        return (f"  for (int c = 0; c < {num_class}; ++c)"
                " out[c] = std::exp(out[c]);\n")
    return ""


def model_to_if_else(booster) -> str:
    """Generate the C++ translation unit for a loaded model.

    ``booster`` is a ``LoadedBooster`` (io/model_text.py) — convert a
    live ``Booster`` by round-tripping through its model text,
    which is the same path the reference CLI uses (a saved model is the
    input of ``task=convert_model``, application.cpp).
    """
    models = booster.models
    k = booster.num_tree_per_iteration
    num_feat = booster.max_feature_idx + 1
    out: List[str] = [_PRELUDE, "\n"]
    for i, t in enumerate(models):
        _emit_tree(t, i, out)

    out.append(f"""
LGBM_EXPORT int GetNumClasses() {{ return {k}; }}
LGBM_EXPORT int GetNumTrees() {{ return {len(models)}; }}
LGBM_EXPORT int GetNumFeatures() {{ return {num_feat}; }}

LGBM_EXPORT void PredictRaw(const double* a, double* out) {{
  for (int c = 0; c < {k}; ++c) out[c] = 0.0;
""")
    for i in range(len(models)):
        out.append(f"  out[{i % k}] += PredictTree{i}(a);\n")
    if booster.average_output and models:
        n_iter = max(len(models) // k, 1)
        out.append(f"  for (int c = 0; c < {k}; ++c) "
                   f"out[c] /= {n_iter}.0;\n")
    out.append("}\n")

    out.append(f"""
LGBM_EXPORT void Predict(const double* a, double* out) {{
  PredictRaw(a, out);
{_transform_code(booster.objective_str, k)}}}
""")
    return "".join(out)


def convert_model_file(input_model: str, output_file: str) -> None:
    """CLI ``task=convert_model``: model text file -> C++ source file."""
    from .model_text import load_model_from_file
    booster = load_model_from_file(input_model)
    with open(output_file, "w") as fh:
        fh.write(model_to_if_else(booster))
