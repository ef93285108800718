"""Deterministic fault-injection harness (copy of
``lightgbm_tpu/robustness/faults.py`` for the PyTorch port: the same
grammar and kinds. The training path fires ``nan_grad``, ``sigterm``,
``torn_checkpoint`` and ``fail_read``; over ranks ``kill_rank`` and
``stall_rank`` at the iteration boundary (``maybe_rank_fault``) and
``drop_heartbeat`` in the elastic watchdog's sender
(``robustness/elastic.py``); the serving registry's model reads go
through ``retry.py`` and take ``fail_read``; the process fleet's
supervisor (``serving/procfleet.py``) takes the replica kinds; the replay
log source (``pipeline/logsource.py``) takes the drift kind).

Every robustness feature in this package (checkpoint fallback, retry/
backoff, non-finite guards, preemption handling) is tested through this
one mechanism: a **fault plan** parsed from a spec string names exactly
which faults fire, where, and how many times — no randomness, no
timing races, fully reproducible.

Spec grammar (``LGBM_TPU_FAULTS`` env var or the ``faults`` config
parameter; the config parameter wins when both are set)::

    spec    := event (";" event)*
    event   := kind ["@" arg ("," arg)*]
    arg     := key "=" value

Supported kinds and their args:

* ``nan_grad@iteration=N[,value=inf]`` — poison one gradient entry at
  boosting iteration ``N`` (0-based, absolute) with NaN (or +inf).
* ``sigterm@iteration=N`` — deliver SIGTERM to this process at the
  start of iteration ``N`` (the preemption drill).
* ``torn_checkpoint@nth=K`` — truncate a payload file of the K-th
  checkpoint write (1-based) *after* its manifest digests were
  computed, simulating a torn/corrupted write that the manifest
  validation must catch.
* ``fail_read@times=K[,match=SUBSTR]`` — the first ``K`` guarded file
  reads whose path contains ``SUBSTR`` (all reads when omitted) raise
  ``OSError`` (exercises the retry/backoff wrappers).
* ``drift@window=K[,shift=V,feature=J,flip=P,once=1]`` — from
  replay-stream window ``K`` on, the pipeline log source draws
  drifted data: feature ``J``'s mean shifts by ``V`` and/or labels
  flip with probability ``P``; ``once=1`` poisons only window ``K``
  (``pipeline/logsource.py`` — the continuous-refit drill's
  deterministic drift injection).
* ``crash_replica@rid=K[,signal=9]`` — the process-fleet supervisor
  (``serving/procfleet.py``) arms replica ``K``'s worker process to
  kill itself with ``signal`` (default SIGKILL): the hard-death
  drill — the supervisor must re-dispatch its requests and respawn
  it within the backoff budget.
* ``hang_replica@rid=K,ms=V`` — replica ``K``'s worker stops
  answering (its receive loop sleeps ``V`` ms): heartbeats go stale
  and the supervisor must declare ``heartbeat_lost`` and recover.
* ``oom_replica@rid=K`` — replica ``K``'s worker exits with the
  OOM-kill status (137), simulating the kernel/device OOM reaper;
  classified ``oom_killed`` by the supervisor.
* ``kill_rank@rank=R,iter=N`` — in a multi-process training run, rank
  ``R`` SIGKILLs itself at the start of boosting iteration ``N``: the
  pod-preemption drill — the elastic watchdog
  (``robustness/elastic.py``) must classify ``peer_lost`` on every
  surviving rank and abort them within its timeout instead of leaving
  the pod hung in a collective.
* ``stall_rank@rank=R,iter=N,ms=V`` — rank ``R`` sleeps ``V`` ms at
  iteration ``N`` while its heartbeats keep flowing: the survivors'
  stall monitors must classify ``collective_stall``.
* ``drop_heartbeat@rank=R`` — rank ``R`` keeps training but silences
  its heartbeat sender: rank 0 must declare ``peer_lost`` on staleness
  alone (the network-partition drill).

Every event fires a bounded number of times (``times``, default 1 —
``nth``-style events always once) and is *consumed*: reruns inside the
same plan do not re-fire, which is what makes rollback-and-continue
terminate.

Integration points call :func:`get_fault_plan` (cheap: ``None`` when no
spec is configured) and then ``plan.take(kind, **ctx)``.
"""

from __future__ import annotations

import os
import signal
from typing import Any, Dict, List, Optional

from ..utils.log import log_warning

_KNOWN_KINDS = ("nan_grad", "sigterm", "torn_checkpoint", "fail_read",
                "drift", "crash_replica", "hang_replica", "oom_replica",
                "kill_rank", "stall_rank", "drop_heartbeat")


class Fault:
    """One armed fault event from a plan."""

    __slots__ = ("kind", "params", "remaining", "fired")

    def __init__(self, kind: str, params: Dict[str, Any]):
        self.kind = kind
        self.params = params
        self.remaining = int(params.get("times", 1))
        self.fired = 0

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if self.remaining <= 0:
            return False
        if "iteration" in self.params:
            if int(ctx.get("iteration", -1)) != int(
                    self.params["iteration"]):
                return False
        if "nth" in self.params:
            if int(ctx.get("nth", -1)) != int(self.params["nth"]):
                return False
        if "window" in self.params:
            if int(ctx.get("window", -1)) != int(self.params["window"]):
                return False
        if "rid" in self.params:
            if int(ctx.get("rid", -1)) != int(self.params["rid"]):
                return False
        if "rank" in self.params:
            if int(ctx.get("rank", -1)) != int(self.params["rank"]):
                return False
        match = str(self.params.get("match", ""))
        if match and match not in str(ctx.get("path", "")):
            return False
        return True

    def describe(self) -> str:
        args = ",".join(f"{k}={v}" for k, v in sorted(
            self.params.items()))
        return f"{self.kind}@{args}" if args else self.kind


class FaultPlan:
    """A parsed, stateful set of fault events."""

    def __init__(self, events: List[Fault], spec: str = ""):
        self.events = events
        self.spec = spec

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        events: List[Fault] = []
        for raw in (spec or "").replace("\n", ";").split(";"):
            raw = raw.strip()
            if not raw:
                continue
            kind, _, argstr = raw.partition("@")
            kind = kind.strip()
            if kind not in _KNOWN_KINDS:
                log_warning(f"faults: unknown fault kind {kind!r} in "
                            f"spec (known: {', '.join(_KNOWN_KINDS)})")
                continue
            params: Dict[str, Any] = {}
            for arg in argstr.split(","):
                arg = arg.strip()
                if not arg:
                    continue
                key, _, val = arg.partition("=")
                key = key.strip()
                if key == "iter":   # convenience alias
                    key = "iteration"
                val = val.strip()
                try:
                    params[key] = int(val)
                except ValueError:
                    params[key] = val
            events.append(Fault(kind, params))
        return cls(events, spec=spec)

    def take(self, kind: str, **ctx) -> Optional[Fault]:
        """Return (and consume one firing of) the first armed event of
        ``kind`` matching the call-site context, else None."""
        for ev in self.events:
            if ev.kind == kind and ev.matches(ctx):
                ev.remaining -= 1
                ev.fired += 1
                from ..observability.telemetry import get_telemetry
                get_telemetry().count("faults.injected")
                get_telemetry().count(f"faults.{kind}")
                log_warning(f"faults: injecting {ev.describe()} "
                            f"(ctx={ctx})")
                return ev
        return None

    def pending(self) -> List[str]:
        return [ev.describe() for ev in self.events if ev.remaining > 0]


_ACTIVE: List[Optional[FaultPlan]] = [None]
_ENV_SPEC_SEEN: List[Optional[str]] = [None]
_ENV_PLAN: List[Optional[FaultPlan]] = [None]


def set_fault_plan(plan_or_spec) -> Optional[FaultPlan]:
    """Install a process-wide fault plan (a FaultPlan, a spec string,
    or None to clear). Returns the installed plan."""
    if plan_or_spec is None or plan_or_spec == "":
        _ACTIVE[0] = None
    elif isinstance(plan_or_spec, FaultPlan):
        _ACTIVE[0] = plan_or_spec
    else:
        _ACTIVE[0] = FaultPlan.parse(str(plan_or_spec))
    return _ACTIVE[0]


def get_fault_plan() -> Optional[FaultPlan]:
    """The active plan: one installed via :func:`set_fault_plan` (the
    ``faults`` config param routes here), else one parsed once from the
    ``LGBM_TPU_FAULTS`` env var. None when no faults are configured."""
    if _ACTIVE[0] is not None:
        return _ACTIVE[0]
    spec = os.environ.get("LGBM_TPU_FAULTS", "").strip()
    if not spec:
        _ENV_SPEC_SEEN[0] = None
        _ENV_PLAN[0] = None
        return None
    if _ENV_SPEC_SEEN[0] != spec:
        # (re)parse only when the env spec CHANGES: the plan is
        # stateful, and an unchanged spec must keep its consumed
        # counters so single-shot faults stay single-shot
        _ENV_SPEC_SEEN[0] = spec
        _ENV_PLAN[0] = FaultPlan.parse(spec)
    return _ENV_PLAN[0]


def fault_plan_active() -> bool:
    plan = get_fault_plan()
    return plan is not None and bool(plan.pending())


def maybe_fail_read(path: str) -> None:
    """Call before a guarded file read; raises OSError when a
    ``fail_read`` fault is armed for this path."""
    plan = get_fault_plan()
    if plan is not None and plan.take("fail_read", path=path) \
            is not None:
        raise OSError(f"injected read failure for {path!r} "
                      "(LGBM_TPU_FAULTS fail_read)")


def maybe_sigterm(iteration: int) -> None:
    """Call at an iteration boundary; delivers SIGTERM to this process
    when a ``sigterm`` fault is armed for this iteration."""
    plan = get_fault_plan()
    if plan is not None and plan.take("sigterm",
                                      iteration=iteration) is not None:
        os.kill(os.getpid(), signal.SIGTERM)



def maybe_rank_fault(iteration: int, rank: int) -> None:
    """Call at an iteration boundary of a multi-rank run; fires the
    armed ``kill_rank`` / ``stall_rank`` drills of this (rank,
    iteration). ``drop_heartbeat`` is taken inside the elastic
    watchdog's sender, never here: it must not touch the training
    loop."""
    plan = get_fault_plan()
    if plan is None:
        return
    if plan.take("kill_rank", iteration=iteration, rank=rank) is not None:
        # SIGKILL, not SIGTERM: an unannounced death, with no handler,
        # no cleanup and no goodbye, that the watchdog must detect
        os.kill(os.getpid(), signal.SIGKILL)
    ev = plan.take("stall_rank", iteration=iteration, rank=rank)
    if ev is not None:
        import time
        time.sleep(float(ev.params.get("ms", 1000)) / 1000.0)
