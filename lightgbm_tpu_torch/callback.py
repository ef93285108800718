"""Training callbacks (copy of ``lightgbm_tpu/callback.py``, which the
port may not import).

Reference analog: ``python-package/lightgbm/callback.py`` (CallbackEnv
``:22-36``, print_evaluation ``:55``, record_evaluation ``:82``,
reset_parameter ``:111``, early_stopping ``:150``). Same closure-based
design: a callback receives a ``CallbackEnv`` each iteration;
``before_iteration`` callbacks run before the boosting update.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List

from .utils.log import log_info, log_warning


class EarlyStopException(Exception):
    """Raised by callbacks to stop training (callback.py:12-21)."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


# (model, params, iteration, begin_iteration, end_iteration,
#  evaluation_result_list) — callback.py:22-36
CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    """callback.py:39-52."""
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log evaluation results every ``period`` iterations
    (callback.py:55-79)."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            log_info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    """Record evaluation history into ``eval_result``
    (callback.py:82-108)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            name, metric = item[0], item[1]
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            name, metric, value = item[0], item[1], item[2]
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, []).append(value)

    _callback.order = 20
    return _callback


def record_telemetry(result: Dict) -> Callable:
    """Record per-iteration telemetry into ``result`` — the
    observability analog of ``record_evaluation`` (JAX
    ``callback.py:87``).

    After training, ``result["iterations"]`` holds one dict per
    iteration ({iteration, phases, counts, eval, ...} — ``counts`` is
    the per-iteration dispatch/host-sync accounting with the kernel
    launches, ``launch.<kernel>``) and ``result["summary"]`` the
    end-of-run counters and the kernel library's build. The in-memory
    ring sink is enabled on creation when telemetry is otherwise off,
    so the callback works without ``LGBM_TPU_TELEMETRY``/
    ``telemetry_out``. Its ``order`` is not in the inert set
    (engine.py): it steps the loop one iteration at a time."""
    if not isinstance(result, dict):
        raise TypeError("record_telemetry expects a dictionary")
    from .observability.telemetry import get_telemetry
    tel = get_telemetry()
    tel.ensure_ring()

    def _callback(env: CallbackEnv) -> None:
        rec = dict(tel.last_iter or {})
        rec["iteration"] = env.iteration
        if env.evaluation_result_list:
            rec["eval"] = [[r[0], r[1], float(r[2]), bool(r[3])]
                           for r in env.evaluation_result_list]
        result.setdefault("iterations", []).append(rec)
        result["summary"] = {"counters": dict(tel.counters),
                             "compile": tel.compile_stats(),
                             "phase_totals": tel.phase_totals()}

    _callback.order = 25
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters on a schedule: each value is a list (per
    iteration) or a function iteration -> value (callback.py:111-147)."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to "
                        "'num_boost_round'")
                new_param = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_param = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting "
                                 "round index to new parameter value")
            if new_param != env.params.get(key, None):
                new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Early stopping on validation metrics (callback.py:150-229)."""
    best_score: List = []
    best_iter: List = []
    best_score_list: List = []
    cmp_op: List = []
    enabled: List = [True]
    first_metric: List = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            log_warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log_info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for item in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if item[3]:  # bigger is better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _final_iteration_check(env, eval_name_splitted, i) -> None:
        if env.iteration == env.end_iteration - 1:
            if verbose:
                log_info(
                    "Did not meet early stopping. Best iteration is:\n"
                    f"[{best_iter[i] + 1}]\t"
                    + "\t".join(_format_eval_result(x)
                                for x in best_score_list[i]))
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None \
                    or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = \
                env.evaluation_result_list[i][1].split(" ")
            if first_metric_only \
                    and first_metric[0] != eval_name_splitted[-1]:
                continue
            if env.evaluation_result_list[i][0] == "cv_agg" \
                    and eval_name_splitted[0] == "train":
                continue
            if env.evaluation_result_list[i][0] == \
                    getattr(env.model, "_train_data_name", "training"):
                _final_iteration_check(env, eval_name_splitted, i)
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log_info(
                        "Early stopping, best iteration is:\n"
                        f"[{best_iter[i] + 1}]\t"
                        + "\t".join(_format_eval_result(x)
                                    for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)

    _callback.order = 30
    return _callback
