"""Per-tenant token-bucket quotas for the serving fleet (copy of
``lightgbm_tpu/serving/tenants.py`` for the PyTorch port: the same
admissions under the same injected clock).

The fleet's admission control has two layers: the shared bounded
pending count (capacity protection, ``queue_full``) and — first —
these per-tenant token buckets (fairness protection,
``quota_exceeded``). A tenant that exhausts its bucket gets the
structured :class:`~lightgbm_tpu_torch.serving.errors.QuotaExceededError`
immediately with a ``retry_after_s`` hint; its traffic never occupies
queue slots other tenants paid for, and never degrades into a timeout.

A bucket holds up to ``burst`` tokens and refills continuously at
``rate`` tokens/second (the classic token bucket). What one token
buys is the COST UNIT: ``requests`` (the default — one request, one
token, whatever its size) or ``bytes`` (a request costs its decoded
f64 payload bytes, so a tenant's quota bounds the data volume it can
push through the fleet rather than its call count — one 512-row batch
and 512 single-row calls now draw the same budget). ``rate <= 0``
means unlimited (the default tenant when no quota is configured). The
clock is injectable so tests are deterministic.

Config surface (``Config.serving_quota_*``)::

    serving_quota_qps    = 100          # default per-tenant rate
    serving_quota_burst  = 200          # default burst (0 -> 2x rate)
    serving_quota_unit   = requests     # or: bytes (rate = bytes/s)
    serving_quota_tenants = tenantA=10,tenantB=500:1000
                                        # per-tenant rate[:burst]
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .errors import QuotaExceededError


class TokenBucket:
    """One tenant's bucket: ``burst`` capacity, ``rate``/s refill."""

    __slots__ = ("rate", "burst", "tokens", "_last", "_clock", "_lock")

    def __init__(self, rate: float, burst: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(
            2.0 * self.rate, 1.0)
        self.tokens = self.burst
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, cost: float = 1.0) -> Tuple[bool, float]:
        """Take ``cost`` tokens if available. Returns ``(ok,
        retry_after_s)`` — ``retry_after_s`` is how long until the
        bucket can cover the cost (0 when it just did)."""
        if self.rate <= 0:              # unlimited tenant
            return True, 0.0
        now = self._clock()
        with self._lock:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now
            if self.tokens >= cost:
                self.tokens -= cost
                return True, 0.0
            return False, (cost - self.tokens) / self.rate

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "tokens": round(self.tokens, 3)}


def parse_tenant_specs(specs) -> Dict[str, Tuple[float, float]]:
    """``["a=10", "b=500:1000"]`` (or one comma-joined string) ->
    ``{tenant: (rate, burst)}``; burst defaults to 0 (auto)."""
    out: Dict[str, Tuple[float, float]] = {}
    if isinstance(specs, str):
        specs = [s for s in specs.replace(";", ",").split(",") if s]
    for spec in specs or []:
        spec = str(spec).strip()
        if not spec or "=" not in spec:
            continue
        tenant, _, val = spec.partition("=")
        rate_s, _, burst_s = val.partition(":")
        try:
            out[tenant.strip()] = (float(rate_s),
                                   float(burst_s) if burst_s else 0.0)
        except ValueError:
            continue
    return out


class TenantQuotas:
    """Registry of per-tenant buckets with a default policy.

    ``default_rate <= 0`` -> tenants without an explicit quota are
    unlimited (quota enforcement applies only to named tenants).
    """

    COST_UNITS = ("requests", "bytes")

    def __init__(self, default_rate: float = 0.0,
                 default_burst: float = 0.0,
                 tenants: Optional[Dict[str, Tuple[float, float]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 cost_unit: str = "requests"):
        if cost_unit not in self.COST_UNITS:
            raise ValueError(
                f"unknown quota cost unit {cost_unit!r}; one of "
                f"{self.COST_UNITS}")
        self.default_rate = float(default_rate)
        self.default_burst = float(default_burst)
        self.cost_unit = cost_unit
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        for tenant, (rate, burst) in (tenants or {}).items():
            self._buckets[tenant] = TokenBucket(rate, burst, clock=clock)

    @classmethod
    def from_config(cls, cfg,
                    clock: Callable[[], float] = time.monotonic
                    ) -> "TenantQuotas":
        return cls(
            default_rate=float(getattr(cfg, "serving_quota_qps", 0.0)),
            default_burst=float(getattr(cfg, "serving_quota_burst", 0.0)),
            tenants=parse_tenant_specs(
                getattr(cfg, "serving_quota_tenants", [])),
            clock=clock,
            cost_unit=str(getattr(cfg, "serving_quota_unit",
                                  "requests")))

    def request_cost(self, payload_bytes: int) -> float:
        """Token cost of one request whose decoded f64 payload is
        ``payload_bytes`` under the configured cost unit."""
        if self.cost_unit == "bytes":
            return float(max(int(payload_bytes), 1))
        return 1.0

    def set_quota(self, tenant: str, rate: float,
                  burst: float = 0.0) -> None:
        with self._lock:
            self._buckets[tenant] = TokenBucket(rate, burst,
                                                clock=self._clock)

    def bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None and self.default_rate > 0:
                b = TokenBucket(self.default_rate, self.default_burst,
                                clock=self._clock)
                self._buckets[tenant] = b
        return b

    def check(self, tenant: str, cost: float = 1.0) -> None:
        """Admission check: consumes one token or raises the
        structured :class:`QuotaExceededError` shed (HTTP 429). A
        denial leaves an instant marker on the current trace so a
        per-tenant 429 investigation finds the exact admission points
        on the timeline."""
        bucket = self.bucket_for(tenant)
        if bucket is None:
            return
        ok, retry_after = bucket.try_acquire(cost)
        if not ok:
            from ..observability.tracing import get_tracer
            get_tracer().instant(
                "tenant.quota_denied", cat="fleet",
                args={"tenant": tenant, "rate": bucket.rate,
                      "cost": cost, "unit": self.cost_unit,
                      "retry_after_s": round(retry_after, 4)})
            unit = "byte" if self.cost_unit == "bytes" else "request"
            raise QuotaExceededError(
                f"tenant {tenant!r} exceeded its {unit} quota "
                f"({bucket.rate:g}/s, burst {bucket.burst:g})",
                tenant=tenant, rate=bucket.rate, burst=bucket.burst,
                retry_after_s=round(retry_after, 4))

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            buckets = dict(self._buckets)
        out: Dict[str, Any] = {
            "default_rate": self.default_rate,
            "default_burst": self.default_burst,
            "cost_unit": self.cost_unit,
            "tenants": {t: b.snapshot() for t, b in sorted(
                buckets.items())},
        }
        return out


__all__: List[str] = ["TokenBucket", "TenantQuotas",
                      "parse_tenant_specs"]
