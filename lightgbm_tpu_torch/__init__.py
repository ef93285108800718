"""PyTorch/CUDA port of lightgbm_tpu for one Hopper GPU.

The JAX package (``lightgbm_tpu``) stays the reference; this package
imports neither it nor ``jax``. Training of every objective of the JAX
package (regression family, binary, multiclass, cross-entropy, ranking,
or a custom ``fobj``) with valid sets, metrics, callbacks and early
stopping, on a dense matrix of up to 65,536 bins per feature, numerical
or categorical features alike (``categorical_feature``; pandas category
columns):
the partitioned learner for bins that fit a byte, the serial (leaf_id)
learner past that, with the segment histogram, segment partition,
split scan and both fused split steps as hand-written CUDA kernels
(``csrc/``), each beside its plain PyTorch version. Models go in and
out as the reference's model text (``io/model_text.py``): a loaded
model predicts on the card and seeds continued training
(``train(..., init_model=)``); training data may be a CSV / TSV /
LibSVM file (``data/file_loader.py``). Bagging (balanced too), GOSS,
DART and RF sample rows through the same kernels; prediction gives SHAP
contributions (the TreeSHAP kernel, ``csrc/tree_shap.cu``) and stops
early by margin (``pred_early_stop``). ``cv`` cross-validates by
folds of one binned dataset (``Dataset.subset``); ``Booster.refit``
refits a model's leaves on new rows (per-leaf sums through the
``hist_rows`` kernel); the scikit-learn estimators (``LGBMRegressor``,
``LGBMClassifier``, ``LGBMRanker``) fit with or without scikit-learn.
``tree_learner=data|voting|feature`` train over the ranks of a
``torch.distributed`` group (``init_distributed``, one process a rank;
``parallel/``), with the elastic watchdog and the coordinated
checkpoint over the ranks (``robustness/``), or as a world of one
without a group.
``engine.train_many`` trains many models over one Dataset together, a
bucket of them a batch (``multiboost/``: the model-batched root
histogram and leaf step kernels), and ``cv`` batches its folds the
same way under ``multiboost``. ``serving`` serves a model on the card
(``ServingEngine``: micro-batched requests, one CUDA graph a row
bucket, hot reload, an HTTP frontend) and a fleet of them
(``FleetEngine``: replicas in threads or in worker processes, named
models, canary and shadow routing, tenant quotas) with the SLO engine
(``observability/slo.py``) over its counters. ``pipeline`` runs the
continuous refit loop over a fleet (refit, publish, canary ramp,
promote or roll back; ``PipelineDriver``), and ``python -m
lightgbm_tpu_torch task=train|predict|refit|serve|pipeline|convert_model``
is the command line (``cli.py``; ``device_type=cpu`` for the CPU);
``io/codegen.py`` writes a model as C++ source and ``plotting.py``
draws importances, split values, metric curves and trees.
"""

from .basic import Booster, Dataset
from .utils.log import LightGBMError
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .parallel.distributed import init_distributed
from . import serving
from .serving import (FleetEngine, ModelFleet, ModelRegistry,
                      ProcFleetOptions, Replica, Router, ServingConfig,
                      ServingEngine, TenantQuotas)
from .utils.device import resolve_device

try:  # as the JAX package's __init__ (plotting imports matplotlib and
    # graphviz only when it draws)
    from .plotting import (create_tree_digraph, plot_importance,
                           plot_metric, plot_split_value_histogram,
                           plot_tree)
except ImportError:  # pragma: no cover
    pass

__version__ = "0.1.0"

_ESTIMATORS = ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker")


def __getattr__(name):
    """The scikit-learn estimators, imported on first use: scikit-learn
    (where installed) pulls in pandas, which the rest of the port never
    imports unless given a DataFrame."""
    if name in _ESTIMATORS:
        from . import sklearn
        return getattr(sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
