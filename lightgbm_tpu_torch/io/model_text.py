"""Model text in the reference's format (port of
``lightgbm_tpu/io/model_text.py``).

Reference analog: ``GBDT::SaveModelToString`` / ``LoadModelFromString``
(src/boosting/gbdt_model_text.cpp:301-404, 405+) and ``Tree::ToString``
/ the parsing constructor (src/io/tree.cpp:231-268, 590+). The writer
is a copy of the JAX writer line for line: every float goes through
``repr`` of one float64, so a tree the port holds writes the JAX
writer's text, and load -> write is a fixed point. Only the footer's
``[device_type: ...]`` line tells a port-trained model from a JAX one.

Layout (version v3): the header (``num_class``,
``num_tree_per_iteration``, ``label_index``, ``max_feature_idx``,
``objective``, ``feature_names``, ``feature_infos``, ``tree_sizes``),
one ``Tree=`` block a tree, ``end of trees``, then the
``feature_importances:`` and ``parameters:`` footers.
"""

from __future__ import annotations

import io as _io
import json
from typing import Dict, List

import numpy as np

from ..data.binning import BIN_TYPE_CATEGORICAL
from ..models.tree import Tree
from ..ops.partition import MAX_CAT_WORDS

_MODEL_VERSION = "v3"

# decision_type bit layout (include/LightGBM/tree.h:19-20,220-239)
K_CAT_MASK = 1
K_DEFAULT_LEFT_MASK = 2


def _missing_bits(code: int) -> int:
    return (code & 3) << 2


def _missing_code_from_bits(decision_type: int) -> int:
    return (decision_type >> 2) & 3


def _fmt(v: float) -> str:
    """Shortest round-trip text of a float64 (the reference's
    Common::DoubleToStr keeps full double precision)."""
    return repr(float(v))


def _arr(vals, fmt=str) -> str:
    return " ".join(fmt(v) for v in vals)


def _objective_to_string(gbdt) -> str:
    obj = getattr(gbdt, "objective", None)
    if obj is None or isinstance(obj, str):
        # a loaded model echoes its objective line verbatim
        return getattr(gbdt, "objective_str", "")
    name = obj.name()
    parts = [name]
    if name in ("binary", "multiclassova", "cross_entropy",
                "cross_entropy_lambda") and hasattr(obj, "sigmoid"):
        parts.append(f"sigmoid:{_fmt(obj.sigmoid)}")
    if name in ("multiclass", "multiclassova"):
        parts.append(f"num_class:{gbdt.num_class}")
    return " ".join(parts)


def _feature_infos(dataset) -> List[str]:
    """Per-feature value ranges (Dataset feature_infos_): numerical
    "[min:max]", categorical "v:v:...", unused "none"."""
    infos = []
    for j in range(dataset.num_total_features):
        if dataset.used_feature_map[j] < 0:
            infos.append("none")
            continue
        m = dataset.bin_mappers[j]
        if m.bin_type == BIN_TYPE_CATEGORICAL:
            cats = sorted(int(c) for c in m.bin_2_categorical if c >= 0)
            infos.append(":".join(str(c) for c in cats) if cats else "none")
        else:
            infos.append(f"[{_fmt(m.min_val)}:{_fmt(m.max_val)}]")
    return infos


def _tree_to_string(tree: Tree, index: int) -> str:
    n = tree.num_leaves
    s = _io.StringIO()
    s.write(f"Tree={index}\n")
    s.write(f"num_leaves={n}\n")
    nodes = max(n - 1, 0)
    num_cat = sum(1 for i in range(nodes)
                  if tree.decision_type[i] & K_CAT_MASK)
    s.write(f"num_cat={num_cat}\n")

    # categorical nodes: value-space bitsets with boundaries; the
    # node's threshold is its index among the categorical nodes
    thresholds = []
    cat_boundaries = [0]
    cat_words: List[int] = []
    for i in range(nodes):
        if tree.decision_type[i] & K_CAT_MASK:
            cats = np.asarray(tree.cat_threshold[i], np.int64)
            words = [0] * (int(cats.max(initial=0)) // 32 + 1)
            for c in cats:
                words[int(c) // 32] |= 1 << (int(c) % 32)
            cat_words.extend(words)
            cat_boundaries.append(cat_boundaries[-1] + len(words))
            thresholds.append(float(len(cat_boundaries) - 2))
        else:
            thresholds.append(float(tree.threshold[i]))
    dec = [int(tree.decision_type[i])
           | _missing_bits(int(tree.missing_code[i])) for i in range(nodes)]

    if nodes:
        s.write("split_feature=" + _arr(tree.split_feature) + "\n")
        s.write("split_gain=" + _arr(tree.split_gain, _fmt) + "\n")
        s.write("threshold=" + _arr(thresholds, _fmt) + "\n")
        s.write("decision_type=" + _arr(dec) + "\n")
        s.write("left_child=" + _arr(tree.left_child) + "\n")
        s.write("right_child=" + _arr(tree.right_child) + "\n")
    else:
        for k in ("split_feature", "split_gain", "threshold",
                  "decision_type", "left_child", "right_child"):
            s.write(f"{k}=\n")
    s.write("leaf_value=" + _arr(tree.leaf_value, _fmt) + "\n")
    s.write("leaf_weight=" + _arr(tree.leaf_weight, _fmt) + "\n")
    s.write("leaf_count=" + _arr(tree.leaf_count) + "\n")
    if nodes:
        s.write("internal_value=" + _arr(tree.internal_value, _fmt) + "\n")
        s.write("internal_weight=" + _arr(tree.internal_weight, _fmt)
                + "\n")
        s.write("internal_count="
                + _arr(np.asarray(tree.internal_count).astype(np.int64))
                + "\n")
    else:
        for k in ("internal_value", "internal_weight", "internal_count"):
            s.write(f"{k}=\n")
    if num_cat > 0:
        s.write("cat_boundaries=" + _arr(cat_boundaries) + "\n")
        s.write("cat_threshold=" + _arr(cat_words) + "\n")
    if tree.is_linear:
        # piecewise-linear leaves, as parsed (v4-format layout)
        counts = (np.asarray(tree.leaf_features) >= 0).sum(axis=1)
        s.write("is_linear=1\n")
        s.write("leaf_const=" + _arr(tree.leaf_const, _fmt) + "\n")
        s.write("num_features=" + _arr(int(c) for c in counts) + "\n")
        s.write("leaf_features=" + _arr(
            int(tree.leaf_features[li, j])
            for li in range(n) for j in range(int(counts[li]))) + "\n")
        s.write("leaf_coeff=" + _arr(
            (float(tree.leaf_coeff[li, j])
             for li in range(n) for j in range(int(counts[li]))), _fmt)
            + "\n")
    s.write(f"shrinkage={_fmt(tree.shrinkage)}\n")
    s.write("\n")
    return s.getvalue()


def save_model_to_string(gbdt, start_iteration: int = 0,
                         num_iteration: int = -1) -> str:
    """GBDT::SaveModelToString (gbdt_model_text.cpp:301-393) for a
    trained ``GBDT`` (its dataset gives the feature names and infos) or
    a ``LoadedBooster`` (its parsed header does)."""
    dataset = getattr(gbdt, "train_data", None)
    k = gbdt.num_tree_per_iteration
    cfg = getattr(gbdt, "config", None)
    out = _io.StringIO()
    out.write("tree\n")
    out.write(f"version={_MODEL_VERSION}\n")
    out.write(f"num_class={gbdt.num_class}\n")
    out.write(f"num_tree_per_iteration={k}\n")
    out.write(f"label_index={getattr(gbdt, 'label_index', 0)}\n")
    if dataset is not None:
        max_fidx = dataset.num_total_features - 1
        names = dataset.feature_names
    else:
        max_fidx = int(gbdt.max_feature_idx)
        names = gbdt.feature_names \
            or [f"Column_{i}" for i in range(max_fidx + 1)]
    out.write(f"max_feature_idx={max_fidx}\n")
    objective = _objective_to_string(gbdt)
    if objective:
        out.write(f"objective={objective}\n")
    if getattr(gbdt, "average_output", False):
        out.write("average_output\n")
    out.write("feature_names=" + " ".join(names) + "\n")
    mono = getattr(cfg, "monotone_constraints", None) \
        or getattr(gbdt, "monotone_constraints", None)
    if mono:
        out.write("monotone_constraints=" + _arr(mono) + "\n")
    if dataset is not None:
        infos = _feature_infos(dataset)
    else:
        infos = gbdt.feature_infos or ["none"] * (max_fidx + 1)
    out.write("feature_infos=" + " ".join(infos) + "\n")

    total_iter = len(gbdt.models) // k
    start_iteration = min(max(start_iteration, 0), total_iter)
    n_used = len(gbdt.models)
    if num_iteration > 0:
        n_used = min((start_iteration + num_iteration) * k, n_used)
    start_model = start_iteration * k
    tree_strs = [_tree_to_string(t, i - start_model)
                 for i, t in enumerate(gbdt.models[start_model:n_used],
                                       start=start_model)]
    out.write("tree_sizes=" + _arr(len(t) for t in tree_strs) + "\n\n")
    for t in tree_strs:
        out.write(t)
    out.write("end of trees\n")

    imp = feature_importance(gbdt, "split",
                             num_iteration if num_iteration > 0 else 0)
    pairs = sorted([(int(v), names[i]) for i, v in enumerate(imp) if v > 0],
                   key=lambda p: -p[0])
    out.write("\nfeature_importances:\n")
    for v, name in pairs:
        out.write(f"{name}={v}\n")
    out.write("\nparameters:\n")
    params = cfg.to_params() if cfg is not None else gbdt.parameters
    for key, val in params.items():
        out.write(f"[{key}: {val}]\n")
    out.write("end of parameters\n")
    return out.getvalue()


def save_model_to_file(gbdt, filename: str, start_iteration: int = 0,
                       num_iteration: int = -1) -> None:
    with open(filename, "w") as f:
        f.write(save_model_to_string(gbdt, start_iteration, num_iteration))


# ----------------------------------------------------------------------
def _parse_tree_block(lines: Dict[str, str]) -> Tree:
    n = int(lines["num_leaves"])
    num_cat = int(lines.get("num_cat", "0"))

    def ints(key):
        return np.asarray([int(float(x)) for x in lines.get(key, "").split()],
                          np.int32)

    def floats(key):
        return np.asarray([float(x) for x in lines.get(key, "").split()],
                          np.float64)

    def given(key):
        return bool(lines.get(key, "").strip())

    tree = Tree.__new__(Tree)
    tree.num_leaves = n
    nodes = max(n - 1, 0)
    tree.split_feature = ints("split_feature")
    tree.split_feature_inner = tree.split_feature.copy()
    tree.split_gain = floats("split_gain").astype(np.float32)
    thresholds = floats("threshold")
    tree.decision_type = ints("decision_type")
    tree.left_child = ints("left_child")
    tree.right_child = ints("right_child")
    tree.leaf_value = floats("leaf_value")
    tree.leaf_weight = floats("leaf_weight") if given("leaf_weight") \
        else np.zeros(n)
    tree.leaf_count = ints("leaf_count") if given("leaf_count") \
        else np.zeros(n, np.int32)
    tree.internal_value = floats("internal_value") \
        if given("internal_value") else np.zeros(nodes)
    tree.internal_weight = floats("internal_weight") \
        if given("internal_weight") else np.zeros(nodes)
    tree.internal_count = ints("internal_count") \
        if given("internal_count") else np.zeros(nodes, np.int64)
    tree.shrinkage = float(lines.get("shrinkage", "1"))
    tree.leaf_parent = np.full(n, -1, np.int32)
    tree.leaf_depth = np.zeros(n, np.int32)
    tree.ensure_leaf_depth()  # the text carries neither depth nor parent
    tree.missing_code = np.asarray(
        [_missing_code_from_bits(int(d)) for d in tree.decision_type],
        np.int32)
    # no bin mappers: the bin-space fields stay zero
    tree.threshold_bin = np.zeros(nodes, np.int32)
    tree.num_bin = np.zeros(nodes, np.int32)
    tree.default_bin = np.zeros(nodes, np.int32)
    tree.cat_bitsets = np.zeros((max(nodes, 1), MAX_CAT_WORDS), np.uint32)

    # categorical bitsets back to per-node category lists
    tree.cat_threshold = []
    tree.threshold = np.zeros(nodes, np.float64)
    if num_cat > 0:
        bounds = ints("cat_boundaries")
        words = [int(w) & 0xFFFFFFFF for w in
                 lines.get("cat_threshold", "").split()]
    for i in range(nodes):
        tree.threshold[i] = thresholds[i]
        cats = []
        if int(tree.decision_type[i]) & K_CAT_MASK:
            ci = int(thresholds[i])
            for w in range(int(bounds[ci]), int(bounds[ci + 1])):
                for bit in range(32):
                    if (words[w] >> bit) & 1:
                        cats.append((w - int(bounds[ci])) * 32 + bit)
        tree.cat_threshold.append(np.asarray(cats, np.int64))

    # piecewise-linear leaves: parsed so the model round-trips; the
    # predictor refuses them
    if int(lines.get("is_linear", "0")):
        counts = ints("num_features")
        flat_feat = ints("leaf_features")
        flat_coeff = floats("leaf_coeff")
        cmax = max(int(counts.max(initial=0)), 1)
        feats = np.full((n, cmax), -1, np.int32)
        coeff = np.zeros((n, cmax), np.float64)
        pos = 0
        for li in range(n):
            c = int(counts[li])
            feats[li, :c] = flat_feat[pos:pos + c]
            coeff[li, :c] = flat_coeff[pos:pos + c]
            pos += c
        tree.leaf_const = floats("leaf_const")
        tree.leaf_coeff = coeff
        tree.leaf_features = feats
        tree.is_linear = True
    return tree


class LoadedBooster:
    """A model parsed from text (GBDT::LoadModelFromString,
    gbdt_model_text.cpp:405+): its trees and header; ``predictor.py``
    predicts it."""

    def __init__(self):
        self.models: List[Tree] = []
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.label_index = 0
        self.objective_str = ""
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.average_output = False
        self.monotone_constraints: List[int] = []
        self.parameters: Dict[str, str] = {}

    @property
    def num_iterations_trained(self) -> int:
        return len(self.models) // self.num_tree_per_iteration


def load_model_from_string(text: str) -> LoadedBooster:
    booster = LoadedBooster()
    lines = text.split("\n")
    i = 0
    # header until the blank line after tree_sizes
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line:
            if any(ln.startswith("Tree=") for ln in lines[i:i + 2]):
                break
            continue
        if line == "tree" or line.startswith("version="):
            continue
        if line == "average_output":
            booster.average_output = True
            continue
        if "=" in line:
            key, _, val = line.partition("=")
            if key == "num_class":
                booster.num_class = int(val)
            elif key == "num_tree_per_iteration":
                booster.num_tree_per_iteration = int(val)
            elif key == "label_index":
                booster.label_index = int(val)
            elif key == "max_feature_idx":
                booster.max_feature_idx = int(val)
            elif key == "objective":
                booster.objective_str = val
            elif key == "feature_names":
                booster.feature_names = val.split()
            elif key == "feature_infos":
                booster.feature_infos = val.split()
            elif key == "monotone_constraints":
                booster.monotone_constraints = [int(v) for v in val.split()]
            elif key == "tree_sizes":
                break
    # tree blocks
    cur: Dict[str, str] = {}
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line.startswith("Tree="):
            cur = {}
            continue
        if line == "end of trees":
            if cur:
                booster.models.append(_parse_tree_block(cur))
            break
        if not line:
            if cur:
                booster.models.append(_parse_tree_block(cur))
                cur = {}
            continue
        key, _, val = line.partition("=")
        cur[key] = val
    # parameters footer
    in_params = False
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line == "parameters:":
            in_params = True
            continue
        if line == "end of parameters":
            break
        if in_params and line.startswith("[") and ":" in line:
            key, _, val = line[1:-1].partition(": ")
            booster.parameters[key] = val
    return booster


def load_model_from_file(filename: str) -> LoadedBooster:
    with open(filename) as f:
        return load_model_from_string(f.read())


# ----------------------------------------------------------------------
def feature_importance(gbdt, importance_type: str = "split",
                       num_iteration: int = 0) -> np.ndarray:
    """GBDT::FeatureImportance (gbdt.cpp:744-778): per-feature split
    counts or total gains over the used iterations."""
    k = gbdt.num_tree_per_iteration
    models = gbdt.models
    if num_iteration > 0:
        models = models[:num_iteration * k]
    nf = max((int(t.split_feature.max(initial=-1)) for t in models),
             default=-1) + 1
    if getattr(gbdt, "train_data", None) is not None:
        nf = max(nf, gbdt.train_data.num_total_features)
    out = np.zeros(nf)
    for t in models:
        for i in range(t.num_leaves - 1):
            if t.split_gain[i] > 0:
                if importance_type == "split":
                    out[t.split_feature[i]] += 1
                else:
                    out[t.split_feature[i]] += t.split_gain[i]
    return out


# ----------------------------------------------------------------------
def _node_json(tree: Tree, node: int) -> dict:
    """Tree::NodeToJSON (src/io/tree.cpp:286-340)."""
    if node < 0:  # leaf
        leaf = ~node
        d = {
            "leaf_index": int(leaf),
            "leaf_value": float(tree.leaf_value[leaf]),
            "leaf_weight": float(tree.leaf_weight[leaf]),
            "leaf_count": int(tree.leaf_count[leaf]),
        }
        if tree.is_linear:
            used = tree.leaf_features[leaf] >= 0
            d["leaf_const"] = float(tree.leaf_const[leaf])
            d["leaf_features"] = [int(f) for f in
                                  tree.leaf_features[leaf][used]]
            d["leaf_coeff"] = [float(c) for c in
                               tree.leaf_coeff[leaf][used]]
        return d
    is_cat = bool(tree.decision_type[node] & K_CAT_MASK)
    return {
        "split_index": int(node),
        "split_feature": int(tree.split_feature[node]),
        "split_gain": float(tree.split_gain[node]),
        "threshold": sorted(int(c) for c in tree.cat_threshold[node])
        if is_cat else float(tree.threshold[node]),
        "decision_type": "==" if is_cat else "<=",
        "default_left": bool(tree.decision_type[node]
                             & K_DEFAULT_LEFT_MASK),
        "missing_type": ["None", "Zero", "NaN"][
            int(tree.missing_code[node])],
        "internal_value": float(tree.internal_value[node]),
        "internal_weight": float(tree.internal_weight[node]),
        "internal_count": int(tree.internal_count[node]),
        "left_child": _node_json(tree, int(tree.left_child[node])),
        "right_child": _node_json(tree, int(tree.right_child[node])),
    }


def dump_model_json(gbdt, start_iteration: int = 0,
                    num_iteration: int = -1) -> str:
    """GBDT::DumpModel (gbdt_model_text.cpp:21-115)."""
    dataset = getattr(gbdt, "train_data", None)
    k = gbdt.num_tree_per_iteration
    names = dataset.feature_names if dataset is not None else (
        gbdt.feature_names
        or [f"Column_{i}" for i in range(int(gbdt.max_feature_idx) + 1)])
    n_used = len(gbdt.models)
    if num_iteration > 0:
        n_used = min((start_iteration + num_iteration) * k, n_used)
    start_model = start_iteration * k
    trees = []
    for i, t in enumerate(gbdt.models[start_model:n_used]):
        trees.append({
            "tree_index": i,
            "num_leaves": int(t.num_leaves),
            "num_cat": sum(1 for j in range(t.num_leaves - 1)
                           if t.decision_type[j] & K_CAT_MASK),
            "shrinkage": float(t.shrinkage),
            "tree_structure": _node_json(t, 0) if t.num_leaves > 1
            else {"leaf_value": float(t.leaf_value[0])},
        })
    doc = {
        "name": "tree",
        "version": _MODEL_VERSION,
        "num_class": gbdt.num_class,
        "num_tree_per_iteration": k,
        "label_index": getattr(gbdt, "label_index", 0),
        "max_feature_idx": (dataset.num_total_features - 1)
        if dataset is not None else int(gbdt.max_feature_idx),
        "objective": _objective_to_string(gbdt),
        "average_output": bool(getattr(gbdt, "average_output", False)),
        "feature_names": list(names),
        "tree_info": trees,
    }
    return json.dumps(doc, indent=2)
