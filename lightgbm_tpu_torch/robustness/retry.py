"""Bounded retry with jittered exponential backoff (copy of
``lightgbm_tpu/robustness/retry.py`` for the PyTorch port; the jitter is
the same crc32 draw, so the delays equal the JAX package's).

Wraps the operations that fail transiently in real fleets —
``torch.distributed`` bootstrap (the rendezvous not up yet), checkpoint
and model-file reads (NFS blips, torn caches) — behind one policy: ``attempts`` tries, exponential
delay doubling from ``base_delay_s`` up to ``max_delay_s``, plus a
**deterministic** jitter fraction (derived from the call description
and attempt index, not the clock) so retry storms de-synchronize
across a fleet while every single-process test stays reproducible.

Telemetry: ``retry.calls`` / ``retry.retries`` / ``retry.giveups``
counters and ``retry.sleep_s`` accumulate on the process telemetry
singleton; each wait is logged.

File reads inside retried operations go through :func:`read_bytes` /
:func:`read_text`, which consult the fault plan (``fail_read``) first
— that is how the fault-injection tests exercise this module.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Tuple, Type

from ..utils.log import log_warning
from .faults import maybe_fail_read


def _jitter_frac(desc: str, attempt: int) -> float:
    """Deterministic pseudo-jitter in [0, 1): stable for a given
    (description, attempt) pair so tests and fault drills reproduce."""
    h = zlib.crc32(f"{desc}#{attempt}".encode())
    return (h % 1000) / 1000.0


def backoff_delays(attempts: int, base_delay_s: float,
                   max_delay_s: float, desc: str = "",
                   jitter: float = 0.5):
    """The delay schedule ``retry_call`` uses, exposed for tests and
    for callers that manage their own loop."""
    for i in range(max(attempts - 1, 0)):
        d = min(max_delay_s, base_delay_s * (2.0 ** i))
        yield d * (1.0 + jitter * _jitter_frac(desc, i))


def retry_call(fn: Callable, *args,
               attempts: int = 3,
               base_delay_s: float = 0.1,
               max_delay_s: float = 5.0,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               desc: str = "",
               jitter: float = 0.5,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on an exception in ``retry_on``
    retry up to ``attempts`` total tries with jittered exponential
    backoff. The last failure propagates unchanged."""
    from ..observability.telemetry import get_telemetry
    tel = get_telemetry()
    tel.count("retry.calls")
    name = desc or getattr(fn, "__name__", "call")
    delays = list(backoff_delays(attempts, base_delay_s, max_delay_s,
                                 desc=name, jitter=jitter))
    for attempt in range(max(attempts, 1)):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= len(delays):
                tel.count("retry.giveups")
                log_warning(f"retry: {name} failed after "
                            f"{attempt + 1} attempt(s): {e}")
                raise
            delay = delays[attempt]
            tel.count("retry.retries")
            tel.count("retry.sleep_s", delay)
            log_warning(f"retry: {name} attempt {attempt + 1}/"
                        f"{attempts} failed ({e}); retrying in "
                        f"{delay:.2f}s")
            sleep(delay)


def read_bytes(path: str) -> bytes:
    """Guarded single read (fault hook, no retry — wrap with
    :func:`retry_call` at the call site for backoff)."""
    maybe_fail_read(path)
    with open(path, "rb") as fh:
        return fh.read()


def read_text(path: str) -> str:
    maybe_fail_read(path)
    with open(path, "r") as fh:
        return fh.read()
