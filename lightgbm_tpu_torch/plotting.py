"""Plotting library (port of ``lightgbm_tpu/plotting.py``, host-only).

Reference analog: ``python-package/lightgbm/plotting.py`` (same public
surface: ``plot_importance``, ``plot_split_value_histogram``,
``plot_metric``, ``plot_tree``, ``create_tree_digraph``), on top of the
port's Booster introspection (``feature_importance``, ``dump_model``,
the recorded ``evals_result``). matplotlib / graphviz are imported only
when a plot is made, so the package (and the card's path) never needs
them.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .utils.log import log_fatal

__all__ = ["plot_importance", "plot_split_value_histogram", "plot_metric",
           "plot_tree", "create_tree_digraph"]


def _import_pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        log_fatal("You must install matplotlib to plot")
    return plt


def _import_graphviz():
    try:
        import graphviz
    except ImportError:  # pragma: no cover
        log_fatal("You must install graphviz to plot tree")
    return graphviz


def _axes(ax, figsize, dpi):
    if ax is not None:
        return ax
    plt = _import_pyplot()
    _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple] = None,
                    ylim: Optional[Tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: int = 3, **kwargs):
    """Horizontal bar chart of per-feature importance."""
    booster = _to_booster(booster)
    importance = np.asarray(
        booster.feature_importance(importance_type=importance_type))
    names = booster.feature_name()
    if not len(importance):
        log_fatal("Booster's feature_importance is empty")
    pairs = sorted(zip(names, importance), key=lambda kv: kv[1])
    if ignore_zero:
        pairs = [p for p in pairs if p[1] != 0]
    if max_num_features is not None and max_num_features > 0:
        pairs = pairs[-max_num_features:]
    labels, values = zip(*pairs) if pairs else ((), ())
    ax = _axes(ax, figsize, dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    fmt = f"%.{precision}f" if importance_type == "gain" else "%d"
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, fmt % x, va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    else:
        ax.set_xlim(0, max(values) * 1.1 if values else 1)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        ax.set_ylim(-1, len(values))
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8,
                               xlim: Optional[Tuple] = None,
                               ylim: Optional[Tuple] = None,
                               title: Optional[str] =
                               "Split value histogram for "
                               "feature with @index/name@ @feature@",
                               xlabel: Optional[str] = "Feature split value",
                               ylabel: Optional[str] = "Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs):
    """Histogram of the model's split thresholds on one feature."""
    booster = _to_booster(booster)
    names = booster.feature_name()
    if isinstance(feature, str):
        if feature not in names:
            log_fatal(f"Feature {feature} not found")
        fidx = names.index(feature)
        kind = "name"
    else:
        fidx = int(feature)
        kind = "index"
    values: List[float] = []

    def walk(node):
        if "split_feature" in node:
            if int(node["split_feature"]) == fidx \
                    and node.get("decision_type") == "<=":
                values.append(float(node["threshold"]))
            walk(node.get("left_child", {}))
            walk(node.get("right_child", {}))

    for t in booster.dump_model()["tree_info"]:
        walk(t["tree_structure"])
    if not values:
        log_fatal("Cannot plot split value histogram, "
                  f"because feature {feature} was not used in splitting")
    hist, edges = np.histogram(values, bins=bins or min(len(values), 10))
    centers = (edges[:-1] + edges[1:]) / 2
    width = width_coef * (edges[1] - edges[0])
    ax = _axes(ax, figsize, dpi)
    ax.bar(centers, hist, width=width, align="center", **kwargs)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        ax.set_ylim(0, max(hist) * 1.1)
    if title:
        ax.set_title(title.replace("@feature@", str(feature))
                     .replace("@index/name@", kind))
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None, title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "@metric@",
                figsize=None, dpi=None, grid: bool = True):
    """Plot one metric's recorded eval history.

    Accepts an ``evals_result`` dict (from ``record_evaluation``), a
    fitted sklearn wrapper (``evals_result_``), or a Booster whose
    underlying GBDT recorded metric history (reference plotting.py:251
    accepts dict / LGBMModel only; the Booster form is a superset).
    """
    from .sklearn import LGBMModel
    if isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_ or {})
    else:
        b = _to_booster(booster)
        src = getattr(b, "_gbdt", None) or b
        eval_results = deepcopy(getattr(src, "evals_result", None) or {})
    if dataset_names:
        eval_results = {k: v for k, v in eval_results.items()
                        if k in set(dataset_names)}
    if not eval_results:
        log_fatal("eval results cannot be empty")
    ax = _axes(ax, figsize, dpi)
    msets = next(iter(eval_results.values()))
    if metric is None:
        metric = next(iter(msets))
    for name, metrics in eval_results.items():
        if metric not in metrics:
            continue
        results = metrics[metric]
        ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel.replace("@metric@", metric))
    ax.grid(grid)
    return ax


def _node_label(node: Dict[str, Any], show_info: List[str],
                feature_names: Optional[List[str]], precision: int) -> str:
    def fmt(v):
        return f"{v:.{precision}g}" if isinstance(v, float) else str(v)

    if "split_feature" in node:  # internal
        f = node["split_feature"]
        name = feature_names[f] if feature_names else f"Column_{f}"
        dec = node.get("decision_type", "<=")
        lines = [f"{name} {dec} {fmt(node['threshold'])}"]
        for k in ("split_gain", "internal_value", "internal_count",
                  "internal_weight"):
            if k in show_info and k in node:
                lines.append(f"{k.split('_')[-1]}: {fmt(node[k])}")
        return "\n".join(lines)
    lines = [f"leaf {node.get('leaf_index', 0)}: "
             f"{fmt(node.get('leaf_value', 0.0))}"]
    for k in ("leaf_count", "leaf_weight"):
        if k in show_info and k in node:
            lines.append(f"{k.split('_')[-1]}: {fmt(node[k])}")
    return "\n".join(lines)


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: int = 3,
                        orientation: str = "horizontal", **kwargs):
    """Build a graphviz Digraph of one tree."""
    graphviz = _import_graphviz()
    booster = _to_booster(booster)
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        log_fatal(f"tree_index {tree_index} is out of range "
                  f"(model has {len(model['tree_info'])} trees)")
    tree = model["tree_info"][tree_index]
    feature_names = model.get("feature_names")
    show_info = show_info or []
    graph = graphviz.Digraph(**kwargs)
    graph.attr("graph",
               rankdir="LR" if orientation == "horizontal" else "TB")

    def add(node, parent=None, edge=None):
        nid = f"split{node['split_index']}" if "split_feature" in node \
            else f"leaf{node.get('leaf_index', 0)}"
        shape = "rectangle" if "split_feature" in node else "ellipse"
        graph.node(nid, _node_label(node, show_info, feature_names,
                                    precision), shape=shape)
        if parent is not None:
            graph.edge(parent, nid, label=edge)
        if "split_feature" in node:
            add(node["left_child"], nid, "yes")
            add(node["right_child"], nid, "no")

    add(tree["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              dpi=None, show_info: Optional[List[str]] = None,
              precision: int = 3, orientation: str = "horizontal",
              **kwargs):
    """Render one tree via graphviz into a matplotlib axes."""
    plt = _import_pyplot()
    from io import BytesIO
    import matplotlib.image as mimage
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    buf = BytesIO(graph.pipe(format="png"))
    img = mimage.imread(buf)
    ax = _axes(ax, figsize, dpi)
    ax.imshow(img)
    ax.axis("off")
    return ax


def _to_booster(b):
    from .basic import Booster
    from .sklearn import LGBMModel
    if isinstance(b, LGBMModel):
        return b.booster_
    if isinstance(b, Booster):
        return b
    log_fatal("booster must be Booster or LGBMModel")
