"""Raw score -> output for a model known only by its objective line
(port of ``lightgbm_tpu/objective/output.py``; reference
``ObjectiveFunction::ConvertOutput`` dispatch inside ``Predictor``,
src/application/predictor.hpp:39-131).

A model loaded from text has no objective object, only the model
text's ``objective=`` line (name + ``key:value`` params). These
functions convert its raw scores on the scores' own device, in float64,
for every objective name such a line can hold; unknown and
regression-family names are the identity, as the reference's null
converter is. A trained booster's objective object keeps its own
``convert_output``.
"""

from __future__ import annotations

import torch


def objective_param(objective_str: str, key: str, default: float) -> float:
    """One ``key:value`` token of a model-text objective line (e.g.
    ``"binary sigmoid:2"``)."""
    for tok in (objective_str or "").split()[1:]:
        if tok.startswith(key + ":"):
            try:
                return float(tok.split(":", 1)[1])
            except ValueError:
                return default
    return default


def convert_raw_score(objective_str: str, raw: torch.Tensor) -> torch.Tensor:
    """ConvertOutput for a string-named objective. ``raw`` is [N] or
    [N, k]; multiclass softmax runs over the last axis."""
    name = (objective_str or "").split(" ")[0]
    if name in ("binary", "multiclassova"):
        sigmoid = objective_param(objective_str, "sigmoid", 1.0)
        return 1.0 / (1.0 + torch.exp(-sigmoid * raw))
    if name == "cross_entropy":
        return 1.0 / (1.0 + torch.exp(-raw))
    if name == "cross_entropy_lambda":
        return torch.log1p(torch.exp(raw))
    if name == "multiclass":
        e = torch.exp(raw - raw.max(dim=-1, keepdim=True).values)
        return e / e.sum(dim=-1, keepdim=True)
    if name in ("poisson", "gamma", "tweedie"):
        return torch.exp(raw)
    return raw


def convert_output(src, raw: torch.Tensor) -> torch.Tensor:
    """ConvertOutput for a trained GBDT or a loaded model: an objective
    object converts with its own ``convert_output``; otherwise the
    model's objective line decides."""
    obj = getattr(src, "objective", None)
    if obj is not None and not isinstance(obj, str):
        return obj.convert_output(raw)
    return convert_raw_score(getattr(src, "objective_str", ""), raw)
