"""Training entry points (port of ``lightgbm_tpu/engine.py``: ``train``
and ``cv``; reference python-package/lightgbm/engine.py:18-276, 299-580).

``train(params, Dataset, num_boost_round, valid_sets=, valid_names=,
fobj=, feval=, init_model=, feature_name=, categorical_feature=,
early_stopping_rounds=, evals_result=, verbose_eval=, callbacks=)``
(the JAX package's positional order) returns a ``Booster``. It runs on the CUDA
device unless ``device`` says otherwise, and raises when there is none.
With valid sets, ``feval``, ``fobj`` or callbacks it steps one iteration
at a time: the update, one evaluation (one host read of every metric
value), then the callbacks (``callback.py``: print, record, reset
parameters, early stopping, which sets ``best_iteration``). Without
them the booster trains its iterations in one call. ``init_model`` (a
model file's path or a ``Booster``) continues training from that
model's trees. ``ops="plain"`` trains through the kernels' plain
PyTorch versions on the same device (used to check the kernels end to
end). The robustness and observability planes ride the same loop (JAX
``engine.py:140-448``): ``faults`` installs the fault plan,
``checkpoint_dir`` writes checkpoints every ``checkpoint_freq``
iterations and resumes from the newest valid one (``resume=auto``),
installs the SIGTERM/SIGINT guard (a preempted run writes a final
checkpoint, sets ``booster.preempted`` and returns), ``guard_policy``
and ``guard_loss_spike`` raise, skip or roll back, and the flight
recorder dumps on an exception; any of them steps the loop one
iteration at a time. ``telemetry_out`` / ``trace_out`` / ``profile_dir``
record without changing the loop. Over ranks (a parallel learner in a
``torch.distributed`` group of more than one rank; JAX
``engine.py:166-183, 302-310, 425-455``) ``elastic_watchdog`` starts the
heartbeat watchdog (``robustness/elastic.py``): each iteration boundary
raises its verdict (``ElasticError``) and fires the ``kill_rank`` /
``stall_rank`` drills, a collective that raises inside an iteration is
turned into the watchdog's classified ``ElasticError`` when the
watchdog saw the rank go, the checkpoints are coordinated
(``robustness/checkpoint.py``), and ``elastic_shutdown`` leaves the
group at the end of the run.

``cv(params, Dataset, num_boost_round, folds=, nfold=, stratified=,
shuffle=, ...)`` trains one booster a fold, each on a ``subset`` of the
binned data (the parent's bins) with the held-out rows as its valid
set, one iteration of every fold at a time, and returns the mean and
standard deviation of each metric by iteration (``CVBooster`` with
``return_cvbooster``). Folds are whole queries for ranking data
(``_GroupKFold``), stratified by label for binary and multiclass
(``_StratifiedKFold``), else cut from a permutation: the two splitters
are copies of scikit-learn's, so the port needs no scikit-learn. Under
``multiboost`` ("auto" with a power-of-two learning rate, or "on") the
folds train as one ``BoosterBatch`` (``multiboost/``) over the shared
bins, each fold's rows a mask, with the JAX package's gates
(``_cv_multiboost``); otherwise one after another (the per-fold loop).

``train_many(params_list, Dataset, num_boost_round, row_indices=,
return_report=)`` trains many boosters over one Dataset: models whose
static configuration agrees are bucketed (at most
``multiboost_max_batch`` a bucket) and each bucket trains as one
``BoosterBatch``; ineligible and solo models train through ``train``.
"""

from __future__ import annotations

import collections
import copy
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .basic import Booster, Dataset
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       print_evaluation, record_evaluation)
from .config import Config
from .io.model_text import load_model_from_file
from .observability.flightrec import (arm_recorder, disarm_recorder,
                                      dump_exception)
from .observability.telemetry import get_telemetry
from .observability.tracing import get_tracer, profile_close
from .parallel.distributed import (WorldInfo, current_world,
                                   group_rendezvous, group_store,
                                   parse_machines, shutdown_distributed)
from .predictor import predict_raw
from .robustness.checkpoint import CheckpointManager
from .robustness.elastic import ElasticWatchdog, watchdog_bounds_s
from .robustness.faults import (fault_plan_active, maybe_rank_fault,
                                maybe_sigterm, set_fault_plan)
from .robustness.guards import (LossSpikeDetector, LossSpikeError,
                                NonFiniteGradientError)
from .robustness.preempt import PreemptionGuard
from .utils.log import LightGBMError, log_info, log_warning

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "n_iter", "num_tree", "num_trees", "num_round",
                  "num_rounds", "n_estimators")
_ES_ALIASES = ("early_stopping_round", "early_stopping_rounds",
               "early_stopping", "n_iter_no_change")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None, verbose_eval=True,
          keep_training_booster: bool = False, callbacks=None, *,
          device=None, ops: str = "kernel") -> Booster:
    params = copy.deepcopy(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
            log_warning(f"Found `{alias}` in params. Will use it instead "
                        "of argument")
    for alias in _ES_ALIASES:
        if alias in params:
            early_stopping_rounds = int(params.pop(alias))
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    if fobj is not None:
        params["objective"] = "none"
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
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    booster = Booster(params=params, train_set=train_set, device=device,
                      ops=ops)
    gbdt = booster._gbdt
    eval_on_train = False
    valid = []
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        for i, valid_data in enumerate(valid_sets):
            if valid_data is train_set:
                eval_on_train = True
                if valid_names is not None:
                    booster._train_data_name = valid_names[i]
                continue
            if not isinstance(valid_data, Dataset):
                raise TypeError("Training only accepts Dataset object")
            booster.add_valid(valid_data, valid_names[i]
                              if valid_names is not None else f"valid_{i}")
            valid.append(valid_data)

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

        def raw(ds):
            return predict_raw(models, ds.raw_matrix(booster.config),
                               gbdt.device, k)
        gbdt.init_from_models(models, raw(train_set),
                              [raw(ds) for ds in valid])

    # the robustness and observability planes (robustness/,
    # observability/; JAX engine.py:140-193): the fault plan, the
    # checkpoint manager and resume, the loss-spike detector and the
    # flight recorder. Any of the robustness planes steps the loop one
    # iteration at a time (they need iteration boundaries).
    cfg = booster.config
    if cfg.faults:
        set_fault_plan(cfg.faults)
    # the ranks this run spans: its learner's world of more than one
    lrn = gbdt.learner
    world = WorldInfo(lrn.rank, lrn.world_size) \
        if getattr(lrn, "world_size", 1) > 1 else None
    ckpt = None
    resume_info = None
    if cfg.checkpoint_dir:
        group = current_world()
        if world is None and group is not None:
            # every rank would write its own single-process checkpoint
            # into the one directory, over each other's files
            raise ValueError(
                f"checkpoint_dir in a process group of {group.size} ranks "
                f"with a learner of one rank (tree_learner="
                f"{cfg.tree_learner}): a coordinated checkpoint needs a "
                "learner that spans the group (tree_learner=data, voting "
                "or feature); for one model a rank, train it outside the "
                "group")
        ckpt = CheckpointManager.from_config(cfg, world=world)
        ckpt.cleanup_stale()
        if cfg.resume == "auto":
            resume_info = ckpt.restore_latest(booster)
            if resume_info is not None:
                booster.resumed_iteration = resume_info.iteration
                log_info(f"Resuming training from checkpoint iteration "
                         f"{resume_info.iteration} ({resume_info.path})")
    guard_spike = None
    if float(cfg.guard_loss_spike) > 1.0:
        guard_spike = LossSpikeDetector(cfg.guard_loss_spike)
    # the elastic watchdog (robustness/elastic.py): a lost or wedged rank
    # becomes a bounded, classified abort. Host threads and sockets only
    elastic = None
    if world is not None and cfg.elastic_watchdog:
        init_method, group_s = group_rendezvous()
        if group_s is not None and group_s < watchdog_bounds_s(cfg):
            raise ValueError(
                f"the process group's timeout ({group_s:g} s) is shorter "
                "than the elastic watchdog's bounds "
                f"({watchdog_bounds_s(cfg):g} s: the stall or heartbeat "
                "timeout plus the abort grace), so a collective would "
                "time out before the watchdog classifies the failure; "
                "pass a longer timeout_s to init_distributed or shorten "
                "elastic_stall_timeout_ms")
        with get_telemetry().span("elastic.watchdog_start"):
            elastic = ElasticWatchdog.from_config(
                cfg, world.rank, world.size, parse_machines(cfg),
                init_method=init_method, store=group_store()).start()
    robust_active = ckpt is not None or guard_spike is not None \
        or cfg.guard_policy != "off" or fault_plan_active() \
        or elastic is not None
    # crash flight recorder: armed when a dump path resolves
    # (crash_dump / LGBM_TPU_CRASH_DUMP / <telemetry_out>.crash.json)
    flightrec = arm_recorder(cfg, gbdt)

    # callbacks (engine.py:186-204)
    callbacks = set(callbacks) if callbacks is not None else set()
    if verbose_eval is True:
        callbacks.add(print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        callbacks.add(print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(early_stopping(
            early_stopping_rounds,
            first_metric_only=bool(params.get("first_metric_only", False)),
            verbose=bool(verbose_eval)))
    if evals_result is not None:
        callbacks.add(record_evaluation(evals_result))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))
    need_eval = bool(valid) or eval_on_train or feval is not None
    # print and record are inert without evaluation results
    inert = all(getattr(cb, "order", 0) in (10, 20) for cb in after)
    if not need_eval and fobj is None and not before and inert \
            and not (early_stopping_rounds or 0) > 0 \
            and not robust_active:
        try:
            gbdt.train(gbdt.iter + num_boost_round)
        except BaseException as e:
            if flightrec is not None:
                dump_exception(e)
            raise
        finally:
            disarm_recorder(flightrec)
        if world is not None and cfg.elastic_shutdown:
            shutdown_distributed()
        return booster

    # one iteration at a time (engine.py:221-276); iteration numbers are
    # absolute, so best_iteration counts the init model's iterations too.
    # After a resume, ``begin`` is the original run's first iteration
    # (num_boost_round counts from there) and the loop starts at the
    # restored one.
    begin = resume_info.begin_iteration if resume_info is not None \
        else gbdt.iter
    end = begin + num_boost_round
    tel = get_telemetry()
    t_train0 = time.perf_counter()
    results = []
    eval_history = list(resume_info.eval_history) \
        if resume_info is not None else []
    stopped_early = False
    # resume: replay the recorded eval results into the stateful
    # callbacks (early stopping, record_evaluation) so their state, and
    # so the stopping iteration, is the uninterrupted run's; print (10)
    # and telemetry (25) callbacks are not re-fired
    for it_r, results_r in eval_history:
        env = CallbackEnv(model=booster, params=params, iteration=int(it_r),
                          begin_iteration=begin, end_iteration=end,
                          evaluation_result_list=[tuple(r)
                                                  for r in results_r])
        try:
            for cb in after:
                if getattr(cb, "order", 0) in (10, 25) \
                        or not getattr(cb, "replay_on_resume", True):
                    continue
                cb(env)
        except EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            results = stop.best_score
            stopped_early = True
            break

    preempt = None
    rollbacks = 0
    max_rollbacks = int(cfg.guard_max_rollbacks)
    if ckpt is not None:
        preempt = PreemptionGuard().install()
    try:
        i = gbdt.iter
        while not stopped_early and i < end:
            if elastic is not None:
                # the watchdog's verdict at the boundary (the clean half
                # of the bounded abort)
                elastic.check()
            if fault_plan_active():
                maybe_sigterm(i)
                if world is not None:
                    maybe_rank_fault(i, world.rank)
            for cb in before:
                cb(CallbackEnv(model=booster, params=params, iteration=i,
                               begin_iteration=begin, end_iteration=end,
                               evaluation_result_list=None))
            try:
                with tel.span("boosting", trace="boost_iter"):
                    booster.update(fobj=fobj)
            except NonFiniteGradientError as nf:
                if nf.policy != "rollback":
                    raise
                restored = None
                if ckpt is not None and rollbacks < max_rollbacks:
                    restored = ckpt.restore_latest(booster)
                if restored is not None:
                    rollbacks += 1
                    tel.count("guard.rollbacks")
                    log_warning(
                        f"guard: non-finite gradients at iteration {i}; "
                        f"rolled back to checkpoint iteration "
                        f"{restored.iteration} "
                        f"({rollbacks}/{max_rollbacks})")
                    # the checkpoint's own history replaces entries
                    # recorded for the now-undone iterations
                    eval_history = list(restored.eval_history)
                    i = gbdt.iter
                    continue
                if rollbacks >= max_rollbacks:
                    raise
                log_warning("guard: rollback requested but no valid "
                            "checkpoint exists; skipping the iteration "
                            "instead")
                gbdt.skip_iteration()
            except (RuntimeError, OSError) as err:
                # gloo raises where a peer's connection closed: with the
                # watchdog running, the rank's classified verdict
                if elastic is None or isinstance(err, LightGBMError):
                    raise
                verdict = elastic.classify(err)
                if verdict is None:
                    raise
                raise verdict from err

            results = []
            if need_eval:
                with tel.span("eval", trace="eval"):
                    if eval_on_train or valid:
                        results = booster.eval_all(
                            feval, include_train=eval_on_train)
                    elif feval is not None:
                        results = booster.eval_valid(feval)
                tel.eval_results(i, results)
                if guard_spike is not None:
                    spike = guard_spike.check(i, results)
                    if spike is not None:
                        if cfg.guard_policy == "raise":
                            raise LossSpikeError(i, *spike,
                                                 guard_spike.factor)
                        if cfg.guard_policy == "rollback" \
                                and ckpt is not None \
                                and rollbacks < max_rollbacks:
                            restored = ckpt.restore_latest(booster)
                            if restored is not None:
                                rollbacks += 1
                                tel.count("guard.rollbacks")
                                log_warning(
                                    f"guard: loss spike at iteration {i}; "
                                    "rolled back to checkpoint iteration "
                                    f"{restored.iteration}")
                                eval_history = list(restored.eval_history)
                                i = gbdt.iter
                                continue
            try:
                for cb in after:
                    cb(CallbackEnv(model=booster, params=params,
                                   iteration=i, begin_iteration=begin,
                                   end_iteration=end,
                                   evaluation_result_list=results))
            except EarlyStopException as stop:
                booster.best_iteration = stop.best_iteration + 1
                results = stop.best_score
                break
            if ckpt is not None:
                if need_eval:
                    # plain-typed rows: the history is JSON in the
                    # manifest and must replay with exact values
                    eval_history.append(
                        [i, [[r[0], r[1], float(r[2]), bool(r[3])]
                             for r in results]])
                ckpt.maybe_save(booster, eval_history, begin)
                if preempt is not None and preempt.requested:
                    # the in-flight iteration (and its eval) finished
                    # above: write a final checkpoint and stop cleanly
                    ckpt.save(booster, eval_history, begin)
                    booster.preempted = True
                    log_info(f"Training preempted after iteration {i}; "
                             f"checkpoint written to {ckpt.directory} — "
                             "rerun with resume=auto to continue")
                    if flightrec is not None:
                        flightrec.dump("preemption", iteration=i,
                                       checkpoint_dir=ckpt.directory,
                                       signum=preempt.signum)
                    break
            if elastic is not None:
                elastic.progress(i)   # resets the stall clock
            i += 1
    except BaseException as e:
        if flightrec is not None:
            dump_exception(e)
        raise
    finally:
        disarm_recorder(flightrec)
        if elastic is not None:
            # a clean goodbye on a normal exit (a raised verdict has
            # already stopped it, uncleanly)
            elastic.stop()
        if preempt is not None:
            preempt.uninstall()
        # close a profiler capture still in flight and persist the span
        # timeline (this loop bypasses GBDT.train)
        profile_close()
        get_tracer().flush()
    if tel.enabled:
        gbdt.emit_train_end(begin, time.perf_counter() - t_train0)
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for name, metric, score, _ in results or []:
        booster.best_score[name][metric] = score
    if booster.best_iteration <= 0:
        booster.best_iteration = -1
    if world is not None and cfg.elastic_shutdown:
        shutdown_distributed()
    return booster


# ----------------------------------------------------------------------
class CVBooster:
    """The boosters of a cv run, one a fold (engine.py:283-297): a
    method called on it is called on every booster, and returns the
    list of their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(booster, name)(*args, **kwargs)
                    for booster in self.boosters]
        return handler_function


def _check_random_state(seed):
    """scikit-learn's ``check_random_state``."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a "
                     "numpy.random.RandomState instance")


class _StratifiedKFold:
    """scikit-learn 1.9.0's ``StratifiedKFold(n_splits, shuffle,
    random_state).split`` (``sklearn/model_selection/_split.py``
    ``_make_test_folds``): the same numpy calls in the same order, so
    the same folds, without scikit-learn. Classes are numbered by first
    appearance, each class's rows are dealt to the folds in blocks of
    the round-robin allocation over the sorted labels, and with
    ``shuffle`` each class's block order is shuffled by one
    ``RandomState``."""

    def __init__(self, n_splits: int, shuffle: bool = False,
                 random_state=None):
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def _make_test_folds(self, y) -> np.ndarray:
        rng = _check_random_state(self.random_state)
        y = np.asarray(y).ravel()
        _, y_idx, y_inv = np.unique(y, return_index=True,
                                    return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater "
                             "than the number of members in each class.")
        if self.n_splits > np.min(y_counts):
            log_warning(f"The least populated class in y has only "
                        f"{np.min(y_counts)} members, which is less than "
                        f"n_splits={self.n_splits}.")
        y_order = np.sort(y_encoded)
        allocation = np.asarray(
            [np.bincount(y_order[i::self.n_splits], minlength=n_classes)
             for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(
                allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y, groups=None):
        test_folds = self._make_test_folds(y)
        indices = np.arange(len(test_folds))
        for i in range(self.n_splits):
            mask = test_folds == i
            yield indices[~mask], indices[mask]


class _GroupKFold:
    """scikit-learn 1.9.0's ``GroupKFold(n_splits).split`` (no shuffle,
    ``_iter_test_indices``): groups are dealt, most rows first (a stable
    ``argsort`` reversed, so ties go to the later group first), each to
    the fold with the fewest rows so far (``argmin``: the first such
    fold)."""

    def __init__(self, n_splits: int):
        self.n_splits = int(n_splits)

    def split(self, X, y=None, groups=None):
        groups = np.asarray(groups)
        unique_groups, group_idx = np.unique(groups, return_inverse=True)
        if self.n_splits > len(unique_groups):
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of groups: {len(unique_groups)}.")
        n_samples_per_group = np.bincount(group_idx)
        indices = np.argsort(n_samples_per_group, kind="stable")[::-1]
        n_samples_per_group = n_samples_per_group[indices]
        n_samples_per_fold = np.zeros(self.n_splits)
        group_to_fold = np.zeros(len(unique_groups))
        for group_index, weight in enumerate(n_samples_per_group):
            lightest_fold = np.argmin(n_samples_per_fold)
            n_samples_per_fold[lightest_fold] += weight
            group_to_fold[indices[group_index]] = lightest_fold
        fold_of_row = group_to_fold[group_idx]
        rows = np.arange(len(groups))
        for f in range(self.n_splits):
            mask = fold_of_row == f
            yield rows[~mask], rows[mask]


def _make_n_folds(full_data: Dataset, folds, nfold: int, params,
                  seed: int, stratified: bool, shuffle: bool):
    """(train rows, test rows) of each fold (engine.py:299-356): a given
    list or splitter (``split(X, y, groups)``) as it is; whole queries
    for ranking data; stratified by label; else ``nfold`` cuts of a
    permutation."""
    full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group_info = full_data.get_group()
            group = np.repeat(np.arange(len(group_info)), group_info) \
                if group_info is not None else None
            folds = folds.split(X=np.empty(num_data),
                                y=full_data.get_label(), groups=group)
        return list(folds)
    group_info = full_data.get_group()
    if group_info is not None:
        group_info = np.asarray(group_info, np.int64)
        flatted_group = np.repeat(np.arange(len(group_info)), group_info)
        return list(_GroupKFold(nfold).split(np.empty(num_data),
                                             groups=flatted_group))
    if stratified:
        # no random_state without shuffle: it would draw nothing
        # (scikit-learn refuses the pair)
        skf = _StratifiedKFold(nfold, shuffle=shuffle,
                               random_state=seed if shuffle else None)
        return list(skf.split(np.empty(num_data), full_data.get_label()))
    rng = np.random.RandomState(seed)
    idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
    kstep = num_data // nfold
    out = []
    for i in range(nfold):
        test = idx[i * kstep: (i + 1) * kstep if i < nfold - 1 else None]
        out.append((np.setdiff1d(idx, test), test))
    return out


def _agg_cv_result(raw_results, eval_train_metric: bool = False):
    """(``"cv_agg"``, metric, mean, bigger_better, stdv) of every metric
    over the folds (engine.py:359-373); with train metrics the dataset's
    name prefixes the metric."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}" if eval_train_metric \
                else one_line[1]
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True, metrics=None,
       fobj=None, feval=None, init_model=None, feature_name="auto",
       categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False, return_cvbooster: bool = False, *,
       device=None, ops: str = "kernel"):
    """k-fold cross-validated boosting (engine.py:375-580): a dict of
    ``"<metric>-mean"`` / ``"<metric>-stdv"`` lists by iteration (cut
    to the best iteration by early stopping), with ``"cvbooster"`` when
    ``return_cvbooster``. Each fold's booster trains on its rows'
    ``subset`` of ``train_set`` on ``device`` (the card unless it says
    otherwise) through ``ops``, or, where ``_cv_multiboost`` batches the
    folds, as one model of a ``BoosterBatch`` over all rows with its
    held-out rows masked (its booster then read back from its text).
    ``init_model`` is accepted and unused, as in the JAX package."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = copy.deepcopy(params)
    for alias in _ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _ES_ALIASES:
        if alias in params:
            early_stopping_rounds = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        params["metric"] = metrics
    obj = params.get("objective", "")
    if stratified and (obj not in ("binary", "multiclass", "multiclassova")
                       or train_set.group is not None):
        stratified = False
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    train_set.params = {**params, **train_set.params}
    folds = _make_n_folds(train_set, folds, nfold, params, seed,
                          stratified, shuffle)

    mb_out = _cv_multiboost(
        params, train_set, folds, num_boost_round, fobj, feval,
        early_stopping_rounds, verbose_eval, show_stdv, callbacks,
        eval_train_metric, return_cvbooster, device, ops)
    if mb_out is not None:
        return mb_out

    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        tr = train_set.subset(np.asarray(train_idx))
        te = train_set.subset(np.asarray(test_idx))
        booster = Booster(params=params, train_set=tr, device=device,
                          ops=ops)
        booster.add_valid(te, "valid")
        cvbooster._append(booster)

    results = collections.defaultdict(list)
    before, after = _cv_sorted_callbacks(callbacks, early_stopping_rounds,
                                         verbose_eval, show_stdv)
    for i in range(num_boost_round):
        for cb in before:
            cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=None))
        raw = []
        for booster in cvbooster.boosters:
            booster.update(fobj=fobj)
            one = []
            if eval_train_metric:
                one.extend(booster.eval_train(feval))
            one.extend(booster.eval_valid(feval))
            raw.append(one)
        res = _agg_cv_result(raw, eval_train_metric)
        for _, key, mean, _, std in res:
            results[f"{key}-mean"].append(mean)
            results[f"{key}-stdv"].append(std)
        try:
            for cb in after:
                cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=res))
        except EarlyStopException as stop:
            cvbooster.best_iteration = stop.best_iteration + 1
            for k in results:
                results[k] = results[k][:cvbooster.best_iteration]
            break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)


# ----------------------------------------------------------------------
def _lr_is_pow2(lr: float) -> bool:
    """True when the learning rate is a power of two (JAX
    ``engine.py:648``): the JAX package's batched score step
    ``f32(leaf) * f32(lr)`` then equals its loop's
    ``f32(f64(leaf) * lr)`` bitwise. The port's batch shrinks in float64
    at any rate; "auto" keeps the JAX package's gate all the same."""
    import math
    m, _ = math.frexp(float(lr))
    return m == 0.5


def _cv_sorted_callbacks(callbacks, early_stopping_rounds, verbose_eval,
                         show_stdv):
    """cv's (before, after) callbacks, each sorted by ``order``."""
    callbacks = set(callbacks) if callbacks is not None else set()
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.add(early_stopping(early_stopping_rounds,
                                     verbose=False))
    if verbose_eval is True:
        callbacks.add(print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        callbacks.add(print_evaluation(verbose_eval, show_stdv))
    before = {cb for cb in callbacks
              if getattr(cb, "before_iteration", False)}
    after = callbacks - before
    return (sorted(before, key=lambda cb: getattr(cb, "order", 0)),
            sorted(after, key=lambda cb: getattr(cb, "order", 0)))


def _cv_multiboost(params, train_set, folds, num_boost_round, fobj,
                   feval, early_stopping_rounds, verbose_eval,
                   show_stdv, callbacks, eval_train_metric,
                   return_cvbooster, device=None, ops="kernel"):
    """Batched cv (JAX ``engine.py:673``): every fold's booster grows
    its tree in one ``BoosterBatch`` iteration over the shared bins, its
    training rows a mask, its held-out rows scored from the batch's
    train scores.

    Returns the cv results dict, or None to fall back to the per-fold
    loop. Gates (multiboost=auto): eligibility of the config for the
    batch, no bagging (fold masks own the row-weight slot), no custom
    fobj/feval, no before-iteration callbacks, and a power-of-two
    learning rate (the JAX package's gate, kept as it is).
    multiboost=on batches at any rate, and raises ``LightGBMError``
    where the JAX package does."""
    from .metric import create_metrics
    from .metric.metrics import batched_eval
    from .multiboost.batch import (BoosterBatch, ModelSpec,
                                   MultiboostError, _meta_view,
                                   multiboost_ineligible_reason,
                                   multiboost_mode)

    cfg = Config.from_params(params)
    mode = multiboost_mode(cfg)
    if mode == "off" or fobj is not None or feval is not None:
        return None
    reason = multiboost_ineligible_reason(cfg, train_set._construct())
    if reason is None and cfg.bagging_freq > 0 \
            and cfg.bagging_fraction < 1.0:
        reason = "bagging (fold masks own the row-weight slot)"
    if reason is None and mode == "auto" \
            and not _lr_is_pow2(cfg.learning_rate):
        reason = f"learning_rate={cfg.learning_rate} not a power of " \
                 "two (set multiboost=on to force)"
    cb_before, cb_after = _cv_sorted_callbacks(
        callbacks, early_stopping_rounds, verbose_eval, show_stdv)
    if reason is None and cb_before:
        reason = "before-iteration callbacks (reset_parameter)"
    if reason is not None:
        if mode == "on":
            raise LightGBMError(f"multiboost=on but cv cannot batch: "
                                f"{reason}")
        log_info(f"multiboost: cv falls back to per-fold loop "
                 f"({reason})")
        return None

    specs = [ModelSpec(params=copy.deepcopy(params),
                       row_index=np.asarray(tr_idx), name=f"fold{f}")
             for f, (tr_idx, _te) in enumerate(folds)]
    try:
        bb = BoosterBatch(train_set, specs, num_boost_round, device=device,
                          ops=ops)
        bb.setup()
    except MultiboostError as e:
        if mode == "on":
            raise LightGBMError(f"multiboost=on but cv cannot batch: "
                                f"{e}") from e
        log_info(f"multiboost: cv falls back to per-fold loop ({e})")
        return None

    dev = bb.device
    md = bb.inner.metadata
    valid_metrics, train_metrics = [], []
    te_dev, tr_dev = [], []
    for f, (tr_idx, te_idx) in enumerate(folds):
        te_idx = np.sort(np.asarray(te_idx, np.int64))
        ms = create_metrics(cfg.resolved_metrics(), cfg)
        for m in ms:
            m.init(_meta_view(md, te_idx), int(len(te_idx)), dev)
        valid_metrics.append(ms)
        te_dev.append(torch.as_tensor(te_idx, device=dev))
        if eval_train_metric:
            tr_idx = np.sort(np.asarray(tr_idx, np.int64))
            mt = create_metrics(cfg.resolved_metrics(), cfg)
            for m in mt:
                m.init(_meta_view(md, tr_idx), int(len(tr_idx)), dev)
            train_metrics.append(mt)
            tr_dev.append(torch.as_tensor(tr_idx, device=dev))

    cvbooster = CVBooster()
    results = collections.defaultdict(list)
    objective = bb._obj_eval[0]
    for i in range(num_boost_round):
        for cb in cb_before:
            cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                           begin_iteration=0,
                           end_iteration=num_boost_round,
                           evaluation_result_list=None))
        bb.step()
        jobs, shape = [], []
        score = bb.scores
        for f in range(len(folds)):
            # the JAX package's batched route names the training rows
            # "train" (its loop: "training")
            if eval_train_metric:
                jobs.append((train_metrics[f], score[f][tr_dev[f]],
                             "train"))
            jobs.append((valid_metrics[f], score[f][te_dev[f]],
                         "valid"))
            shape.append(2 if eval_train_metric else 1)
        per_job = batched_eval(jobs, objective)
        raw, k = [], 0
        for njobs in shape:
            one = []
            for rows in per_job[k:k + njobs]:
                one.extend(rows)
            raw.append(one)
            k += njobs
        res = _agg_cv_result(raw, eval_train_metric)
        for _, key, mean, _, std in res:
            results[f"{key}-mean"].append(mean)
            results[f"{key}-stdv"].append(std)
        try:
            for cb in cb_after:
                cb(CallbackEnv(model=cvbooster, params=params,
                               iteration=i, begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=res))
        except EarlyStopException as stop:
            cvbooster.best_iteration = stop.best_iteration + 1
            for key in results:
                results[key] = results[key][:cvbooster.best_iteration]
            break
    bb.finalize()
    if return_cvbooster:
        for f in range(len(folds)):
            cvbooster._append(bb.booster(f))
        results["cvbooster"] = cvbooster
    return dict(results)


# ----------------------------------------------------------------------
def train_many(params_list: List[Dict[str, Any]], train_set: Dataset,
               num_boost_round: int = 100, row_indices=None,
               return_report: bool = False, *, device=None,
               ops: str = "kernel"):
    """Train many boosters over one Dataset, batching models whose
    static configuration agrees (JAX ``engine.py:812``).

    ``params_list`` is one params dict per model (each may carry its
    own ``num_boost_round`` alias). Models are bucketed by their static
    configuration (num_leaves, max_bin, objective, ...: everything but
    the per-model hyperparameters of ``multiboost.VMAPPED_PARAMS``), each
    bucket of at most ``multiboost_max_batch`` models trains as one
    :class:`~lightgbm_tpu_torch.multiboost.BoosterBatch`, and ineligible
    or solo models (under "auto") fall back to :func:`train`. Results
    come back in input order; batched models are byte-identical to
    their ``train`` twins. ``row_indices`` optionally gives a per-model
    row subset (a mask in the batch; a loop twin trains on
    ``train_set.subset(idx)``). ``return_report=True`` also returns the
    report: models, buckets (names, rounds, size, route), the loop
    fallbacks with their reasons, batched_models, batched_seconds and
    loop_seconds. ``device``: the card unless it says otherwise; ``ops``
    as ``train``."""
    from .multiboost.batch import (BoosterBatch, ModelSpec,
                                   MultiboostError, bucket_models,
                                   multiboost_ineligible_reason,
                                   multiboost_mode)

    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    if row_indices is not None and len(row_indices) != len(params_list):
        raise ValueError("row_indices must align with params_list")

    specs: List[ModelSpec] = []
    rounds: List[int] = []
    configs: List[Config] = []
    for i, p in enumerate(params_list):
        p = copy.deepcopy(p)
        nbr = int(num_boost_round)
        for alias in _ROUND_ALIASES:
            if alias in p:
                nbr = int(p.pop(alias))
        for alias in _ES_ALIASES:
            p.pop(alias, None)
        idx = None if row_indices is None else row_indices[i]
        if idx is not None:
            idx = np.asarray(idx)
        specs.append(ModelSpec(params=p, row_index=idx,
                               name=f"model{i}"))
        rounds.append(nbr)
        configs.append(Config.from_params(p))

    inner = train_set._construct()

    def _loop_reason(i: int) -> Optional[str]:
        cfg = configs[i]
        if multiboost_mode(cfg) == "off":
            return "multiboost=off"
        r = multiboost_ineligible_reason(cfg, inner)
        if r is not None:
            return r
        if specs[i].row_index is not None and cfg.bagging_freq > 0 \
                and cfg.bagging_fraction < 1.0:
            return "bagging combined with row masks"
        return None

    boosters: List[Optional[Booster]] = [None] * len(specs)
    report = {"models": len(specs), "buckets": [], "loop_fallback": []}
    batchable: List[int] = []
    for i in range(len(specs)):
        r = _loop_reason(i)
        if r is None:
            batchable.append(i)
        else:
            report["loop_fallback"].append(
                {"model": specs[i].name, "reason": r})

    # rounds are part of the static key: one batch steps one bucket
    by_rounds: Dict[int, List[int]] = collections.defaultdict(list)
    for i in batchable:
        by_rounds[rounds[i]].append(i)
    t0 = time.perf_counter()
    for nbr, group in by_rounds.items():
        cap = max(int(configs[group[0]].multiboost_max_batch), 1)
        buckets = bucket_models([specs[i] for i in group],
                                [configs[i] for i in group],
                                max_batch=cap)
        for bucket in buckets:
            orig = [group[j] for j, _s, _c in bucket]
            if len(bucket) == 1 and \
                    multiboost_mode(configs[orig[0]]) != "on":
                report["loop_fallback"].append(
                    {"model": specs[orig[0]].name,
                     "reason": "solo bucket (auto mode)"})
                continue
            try:
                bb = BoosterBatch(train_set,
                                  [s for _i, s, _c in bucket], nbr,
                                  configs=[c for _i, _s, c in bucket],
                                  device=device, ops=ops)
                bb.train()
            except MultiboostError as e:
                for i in orig:
                    report["loop_fallback"].append(
                        {"model": specs[i].name, "reason": str(e)})
                continue
            for b, i in enumerate(orig):
                boosters[i] = bb.booster(b)
            report["buckets"].append(
                {"models": [specs[i].name for i in orig],
                 "rounds": nbr, "size": len(orig),
                 "route": bb.describe()["route"]})
    report["batched_seconds"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    for i in range(len(specs)):
        if boosters[i] is not None:
            continue
        ds = train_set if specs[i].row_index is None \
            else train_set.subset(specs[i].row_index)
        boosters[i] = train(dict(specs[i].params), ds,
                            num_boost_round=rounds[i], device=device,
                            ops=ops)
    report["loop_seconds"] = time.perf_counter() - t1
    report["batched_models"] = sum(b["size"] for b in report["buckets"])
    get_telemetry().record(
        "multiboost_report",
        models=report["models"],
        batched_models=report["batched_models"],
        buckets=len(report["buckets"]),
        bucket_sizes=",".join(str(b["size"])
                              for b in report["buckets"]),
        loop_fallback=len(report["loop_fallback"]),
        fallback_reasons="; ".join(sorted(
            {f["reason"] for f in report["loop_fallback"]})),
        batched_seconds=round(report["batched_seconds"], 6),
        loop_seconds=round(report["loop_seconds"], 6))
    if return_report:
        return boosters, report
    return boosters
