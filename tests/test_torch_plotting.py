"""The port's plotting (``lightgbm_tpu_torch/plotting.py``) against the
JAX package's (``lightgbm_tpu/plotting.py``), on the Agg backend.

On one model text (``tests/test_plotting.py``'s data, trained by the JAX
package) both packages draw the same bars (widths and heights, value
labels, tick labels, limits, titles) for ``plot_importance`` and
``plot_split_value_histogram``, and ``create_tree_digraph`` writes the
same graphviz source. ``plot_metric`` draws the curves each package
recorded while training the same data (train and valid logloss within
1e-5), from an ``evals_result`` dict and a fitted estimator (a Booster
from ``train`` carries no history in either package).
``plot_tree`` renders one image where graphviz's ``dot`` is installed.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402

PARAMS = {"objective": "binary", "num_leaves": 7,
          "metric": "binary_logloss", "verbosity": -1}
NAMES = [f"f{i}" for i in range(7)]


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(500, 7)
    X[:, 6] = 1.0  # constant: never split on (pre-filtered)
    y = (X[:, 0] - X[:, 1] + 0.2 * rng.randn(500) > 0).astype(float)
    return X, y


def _train(mod, X, y, **kw):
    train = mod.Dataset(X[:400], label=y[:400], feature_name=NAMES)
    valid = train.create_valid(X[400:], label=y[400:])
    evals = {}
    bst = mod.train(dict(PARAMS), train, num_boost_round=8,
                    valid_sets=[train, valid], valid_names=["train", "valid"],
                    evals_result=evals, verbose_eval=False, **kw)
    return bst, evals


@pytest.fixture(scope="module")
def boosters(data):
    """(port, JAX) boosters of the JAX package's model text."""
    text = _train(lgb, *data)[0].model_to_string()
    return lt.Booster(model_str=text, device="cpu"), lgb.Booster(
        model_str=text)


def _bars(ax):
    return ([(p.get_x(), p.get_y(), p.get_width(), p.get_height())
             for p in ax.patches],
            [t.get_text() for t in ax.get_yticklabels()],
            [(t.get_position(), t.get_text()) for t in ax.texts],
            ax.get_xlim(), ax.get_ylim(), ax.get_title(), ax.get_xlabel(),
            ax.get_ylabel())


@pytest.mark.parametrize("kw", [
    {}, {"importance_type": "gain", "max_num_features": 2, "title": "G"},
    {"ignore_zero": False, "precision": 2, "importance_type": "gain"}])
def test_plot_importance_matches_jax(boosters, kw):
    port, jax = (_bars(lib.plot_importance(b, **kw))
                 for lib, b in zip((lt, lgb), boosters))
    assert port == jax
    assert port[0] and (kw.get("title") or "Feature importance") == port[5]
    assert "f0" in port[1] and "f6" not in port[1]


@pytest.mark.parametrize("feature,bins", [("f0", None), (0, None),
                                          (1, 3)])
def test_plot_split_value_histogram_matches_jax(boosters, feature, bins):
    port, jax = (_bars(lib.plot_split_value_histogram(b, feature,
                                                      bins=bins))
                 for lib, b in zip((lt, lgb), boosters))
    assert port == jax and port[0]
    with pytest.raises(LightGBMError, match="not used in splitting"):
        lt.plot_split_value_histogram(boosters[0], "f6")


def _lines(ax):
    return [(ln.get_label(), np.asarray(ln.get_xdata()),
             np.asarray(ln.get_ydata())) for ln in ax.lines]


def _same_curves(port_ax, jax_ax):
    port, jax = _lines(port_ax), _lines(jax_ax)
    assert [p[0] for p in port] == [j[0] for j in jax]
    for (_, px, py), (_, jx, jy) in zip(port, jax):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-5)
    assert port_ax.get_ylabel() == jax_ax.get_ylabel()
    assert port_ax.get_title() == jax_ax.get_title()
    return len(port)


def test_plot_metric_matches_jax(data):
    (pb, pe), (jb, je) = _train(lt, *data, device="cpu"), _train(lgb, *data)
    assert _same_curves(lt.plot_metric(pe), lgb.plot_metric(je)) == 2
    assert lt.plot_metric(pe).get_ylabel() == "binary_logloss"
    assert _same_curves(lt.plot_metric(pe, dataset_names=["valid"]),
                        lgb.plot_metric(je, dataset_names=["valid"])) == 1
    # lt.train records its history through evals_result, not on the
    # booster, as JAX's does: a Booster alone has none to draw
    for lib, bst in ((lt, pb), (lgb, jb)):
        with pytest.raises(Exception, match="cannot be empty"):
            lib.plot_metric(bst)
    with pytest.raises(LightGBMError, match="cannot be empty"):
        lt.plot_metric({})


def test_plot_metric_and_importance_of_an_estimator():
    rng = np.random.RandomState(2)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(int)
    clf = lt.LGBMClassifier(n_estimators=3, num_leaves=5, verbosity=-1,
                            device="cpu")
    clf.fit(X, y, eval_set=[(X, y)], eval_metric="binary_logloss",
            verbose=False)
    assert len(lt.plot_metric(clf).lines) == 1
    assert len(lt.plot_importance(clf).patches) > 0
    with pytest.raises(LightGBMError, match="Booster or LGBMModel"):
        lt.plot_importance(object())


def test_create_tree_digraph_matches_jax(boosters):
    kw = dict(tree_index=1, show_info=["split_gain", "internal_count",
                                       "leaf_count"], precision=4)
    port, jax = (lib.create_tree_digraph(b, **kw).source
                 for lib, b in zip((lt, lgb), boosters))
    assert port == jax
    assert "yes" in port and "no" in port and "leaf" in port
    assert lt.create_tree_digraph(boosters[0], orientation="vertical"
                                  ).source == lgb.create_tree_digraph(
        boosters[1], orientation="vertical").source
    with pytest.raises(LightGBMError, match="out of range"):
        lt.create_tree_digraph(boosters[0], tree_index=99)


def test_plot_tree(boosters):
    import shutil
    if shutil.which("dot") is None:
        pytest.skip("graphviz's dot binary is not installed")
    ax = lt.plot_tree(boosters[0], tree_index=0)
    assert len(ax.images) == 1
