"""Preemption-safe shutdown: SIGTERM/SIGINT to graceful stop (copy of
``lightgbm_tpu/robustness/preempt.py`` for the PyTorch port).

A cloud preemption (and every container orchestrator) delivers SIGTERM and
expects the process to wind down within a grace window. While a guard
is installed, the first SIGTERM/SIGINT only *sets a flag*; the training
loop finishes the in-flight iteration, writes a final checkpoint, and
returns cleanly. A second signal escalates: the original handler (or
the default action) runs, so a hung loop can still be killed.

Signal handlers can only be installed from the main thread; elsewhere
the guard degrades to a no-op (``installed`` False) instead of
failing — training driven from a worker thread simply has no graceful
preemption, same as before this module existed.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, List, Optional

from ..utils.log import log_info, log_warning

_SIGNALS = (signal.SIGTERM, signal.SIGINT)

# cleanups that MUST run even on the forced (second-signal) path —
# e.g. the process-fleet supervisor's child reaper
# (serving/procfleet.py): escalation may kill this process outright,
# and orphaned worker processes would outlive it. Callables must be
# signal-safe and never raise.
_ESCALATION_CLEANUPS: List[Callable[[], None]] = []


def register_escalation_cleanup(fn: Callable[[], None]) -> None:
    """Run ``fn`` before a second SIGTERM/SIGINT escalates to the
    default disposition (and before KeyboardInterrupt propagates)."""
    if fn not in _ESCALATION_CLEANUPS:
        _ESCALATION_CLEANUPS.append(fn)


def _run_escalation_cleanups() -> None:
    for fn in list(_ESCALATION_CLEANUPS):
        try:
            fn()
        except Exception:  # noqa: BLE001 - escalation must proceed
            pass


class PreemptionGuard:
    """Context manager capturing SIGTERM/SIGINT as a preemption flag."""

    def __init__(self):
        self.requested = False
        self.signum: Optional[int] = None
        self.installed = False
        self._previous: Dict[int, object] = {}

    def _handler(self, signum, frame):
        if self.requested:
            # second signal: escalate to the previous disposition —
            # but reap supervised children first (a process fleet's
            # workers must never outlive an escalated supervisor)
            log_warning(f"preemption: second signal {signum}; "
                        "escalating")
            _run_escalation_cleanups()
            self.uninstall()
            if signum == signal.SIGINT:
                raise KeyboardInterrupt
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signum = signum
        from ..observability.telemetry import get_telemetry
        get_telemetry().count("checkpoint.preemptions")
        log_info(f"preemption: caught signal {signum}; finishing the "
                 "in-flight iteration, then checkpointing and "
                 "shutting down (send again to force)")
        # signal-time durability: dump the flight-recorder black box
        # (the loop may never reach its clean-shutdown path if a
        # dispatch hangs) and flush the JSONL sinks so the trace holds
        # everything recorded so far
        from ..observability.flightrec import notify_signal
        notify_signal(signum)
        get_telemetry().flush()

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        try:
            for s in _SIGNALS:
                self._previous[s] = signal.signal(s, self._handler)
            self.installed = True
        except (ValueError, OSError):  # non-main thread / exotic host
            self.uninstall()
        return self

    def uninstall(self) -> None:
        for s, prev in list(self._previous.items()):
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
