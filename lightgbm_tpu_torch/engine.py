"""Training entry point (port of ``lightgbm_tpu/engine.py:train``).

``train(params, Dataset, num_boost_round)`` returns a ``Booster``. It
runs on the CUDA device unless ``device`` says otherwise, and raises
when there is none. ``init_model`` (a model file's path or a
``Booster``) continues training from that model's trees. Callbacks,
early stopping and valid sets are not in this slice. ``ops="plain"``
trains through the kernels' plain PyTorch versions on the same device
(used to check the kernels end to end).
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from .basic import Booster, Dataset
from .io.model_text import load_model_from_file
from .predictor import predict_raw
from .utils.log import LightGBMError, log_warning

_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                  "num_trees", "num_round", "num_rounds",
                  "num_boost_round", "n_estimators")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, *, init_model=None, device=None,
          ops: str = "kernel") -> Booster:
    params = copy.deepcopy(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            log_warning(f"Found `{alias}` in params. Will use it instead "
                        "of argument")
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    src = None
    if init_model is not None:
        # continued training (reference engine.py:119-130,
        # boosting.cpp:35-68): adopt the existing trees, seed the scores
        if isinstance(init_model, str):
            src = load_model_from_file(init_model)
        elif isinstance(init_model, Booster):
            src = init_model._src()
        else:
            raise TypeError("init_model should be a path or a Booster")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    booster = Booster(params=params, train_set=train_set, device=device,
                      ops=ops)
    gbdt = booster._gbdt
    if src is not None and src.models:
        k = gbdt.num_tree_per_iteration
        if src.num_tree_per_iteration != k or len(src.models) % k != 0:
            raise LightGBMError(
                f"init_model has {src.num_tree_per_iteration} trees per "
                f"iteration ({len(src.models)} trees) but the new booster "
                f"expects {k}; objective/num_class must match for "
                "continued training")
        # the seed: the trees' raw float64 sum per row, tree i into
        # column i % k in tree order (the JAX engine's _raw_add)
        models = [copy.deepcopy(t) for t in src.models]
        gbdt.init_from_models(models, predict_raw(
            models, train_set.raw_matrix(booster.config), gbdt.device, k))
    gbdt.train(num_boost_round)
    return booster
