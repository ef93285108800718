"""Stdlib JSON HTTP frontend for the serving engine (port of
``lightgbm_tpu/serving/http.py``; the CLI's ``serve`` task comes with
ROADMAP.md Queue 1 item 12). Everything is stdlib ``http.server`` on
purpose — the serving container needs no web framework.

Endpoints (all JSON):

* ``POST /predict``    body ``{"rows": [[...], ...]}`` (or ``"row"``)
* ``POST /raw_score``  same body, raw margins
* ``POST /pred_leaf``  same body, per-tree leaf indices
* ``GET  /health``     engine + model-version status
* ``GET  /stats``      counter/latency snapshot
* ``GET  /metrics``    Prometheus text exposition (the live metrics
  plane, docs/Observability.md: serving latency histograms, queue
  depth, shed/timeout counters; in process isolation also every
  federated worker shard under a ``worker`` label)
* ``GET  /slo``        latest SLO burn-rate evaluation
  (observability/slo.py; ``{"enabled": false}`` when no engine runs)
* ``POST /reload``     ``{"model_file": path}`` or ``{"model_str": txt}``

When the engine is a :class:`~lightgbm_tpu_torch.serving.fleet.
FleetEngine`, predict bodies additionally accept ``"model"`` (named
model) and ``"tenant"`` (quota identity; the ``X-Tenant`` header is the
fallback), ``/reload`` accepts ``"model"`` to name the entry being
swapped, and one more route exists (one engine answers it 404):

* ``POST /route``      canary/shadow control:
  ``{"model": m, "canary": target, "weight": w}``,
  ``{"model": m, "shadow": target}``, or ``{"model": m,
  "promote": true}``

Errors are structured (``{"error": code, "message": ...}``) with the
HTTP status from the serving error type: 429 queue-full or
quota-exceeded shed, 504 deadline timeout, 400 malformed input,
404 unknown model, 503 stopped / no healthy replica.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..observability.tracing import get_tracer
from ..utils.log import log_info, log_warning
from .engine import ServingEngine
from .errors import InvalidRequestError, ServingError

_MAX_BODY = 256 << 20  # one request body; predict payloads are rows


class ServingHandler(BaseHTTPRequestHandler):
    engine: ServingEngine = None   # set by make_http_server
    protocol_version = "HTTP/1.1"

    # -- helpers -------------------------------------------------------
    def _send_json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length <= 0:
            raise InvalidRequestError("empty request body")
        if length > _MAX_BODY:
            raise InvalidRequestError("request body too large",
                                      limit=_MAX_BODY)
        try:
            return json.loads(self.rfile.read(length))
        except json.JSONDecodeError as e:
            raise InvalidRequestError(f"invalid JSON: {e}") from e

    def log_message(self, fmt, *args):  # route through our logger
        pass

    def _send_metrics(self) -> None:
        from ..observability.metrics import CONTENT_TYPE, metrics_text
        body = metrics_text().encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- routes --------------------------------------------------------
    def do_GET(self):
        try:
            if self.path == "/health":
                self._send_json(200, self.engine.health())
            elif self.path == "/stats":
                self._send_json(200, self.engine.stats())
            elif self.path == "/metrics":
                self._send_metrics()
            elif self.path == "/slo":
                from ..observability.slo import get_slo_engine
                eng = get_slo_engine()
                self._send_json(200, {
                    "enabled": eng is not None,
                    **(eng.report() if eng is not None else {})})
            else:
                self._send_json(404, {"error": "not_found",
                                      "message": self.path})
        except Exception as e:  # pragma: no cover - defensive
            self._send_json(500, {"error": "internal",
                                  "message": str(e)})

    def do_POST(self):
        try:
            kind = self.path.strip("/")
            if kind in ("predict", "raw_score", "pred_leaf"):
                self._predict(kind)
            elif kind == "reload":
                self._reload()
            elif kind == "route" \
                    and getattr(self.engine, "is_fleet", False):
                self._route()
            else:
                self._send_json(404, {"error": "not_found",
                                      "message": self.path})
        except ServingError as e:
            self._send_json(e.http_status, e.to_dict())
        except Exception as e:  # pragma: no cover - defensive
            log_warning(f"serving http: unhandled error: {e}")
            self._send_json(500, {"error": "internal",
                                  "message": str(e)})

    def _predict(self, kind: str) -> None:
        body = self._read_body()
        rows = body.get("rows", body.get("row"))
        if rows is None:
            raise InvalidRequestError('body needs "rows" (or "row")')
        timeout_ms = body.get("timeout_ms")
        kwargs = {}
        if getattr(self.engine, "is_fleet", False):
            if body.get("model"):
                kwargs["model"] = str(body["model"])
            tenant = body.get("tenant") \
                or self.headers.get("X-Tenant")
            if tenant:
                kwargs["tenant"] = str(tenant)
        tracer = get_tracer()
        if tracer.enabled:
            # the request's root span: an X-Trace-Id header (plain hex
            # or trace-span form) joins the caller's existing trace,
            # otherwise a fresh trace id is minted here. The id is
            # returned in the response so caller-side latency can be
            # joined to the server-side timeline.
            ctx = tracer.from_header(self.headers.get("X-Trace-Id"))
            with tracer.span(f"http.{kind}", cat="http", ctx=ctx,
                             args={"path": self.path}) as root:
                fut = self.engine.submit(
                    rows, kind=kind, timeout_ms=timeout_ms,
                    trace_ctx=root.ctx, **kwargs)
                t = self.engine.config.request_timeout_ms \
                    if timeout_ms is None else float(timeout_ms)
                pred = fut.result(
                    timeout=None if t <= 0 else t / 1000.0 + 5.0)
            meta = dict(fut.meta)
            meta.setdefault("trace_id", root.ctx.trace_id)
        else:
            fut = self.engine.submit(
                rows, kind=kind, timeout_ms=timeout_ms, **kwargs)
            t = self.engine.config.request_timeout_ms \
                if timeout_ms is None else float(timeout_ms)
            pred = fut.result(
                timeout=None if t <= 0 else t / 1000.0 + 5.0)
            meta = fut.meta
        self._send_json(200, {
            "predictions": np.asarray(pred).tolist(), **meta})

    def _reload(self) -> None:
        body = self._read_body()
        source = body.get("model_file") or body.get("model_str")
        if not source:
            raise InvalidRequestError(
                'body needs "model_file" or "model_str"')
        kwargs = {}
        if getattr(self.engine, "is_fleet", False) and body.get("model"):
            kwargs["model"] = str(body["model"])
        version = self.engine.reload(source, **kwargs)
        self._send_json(200, {"status": "ok", "version": version,
                              **kwargs})

    def _route(self) -> None:
        """Fleet canary/shadow control plane (POST /route)."""
        body = self._read_body()
        model = str(body.get("model")
                    or self.engine.default_model)
        out = {"status": "ok", "model": model}
        if body.get("promote"):
            out["promoted"] = self.engine.promote_canary(model)
        elif "canary" in body:
            try:
                self.engine.router.set_canary(
                    model, body.get("canary") or None,
                    float(body.get("weight", 0.0)))
            except (TypeError, ValueError) as e:
                raise InvalidRequestError(str(e)) from e
        elif "shadow" in body:
            self.engine.router.set_shadow(
                model, body.get("shadow") or None)
        else:
            raise InvalidRequestError(
                'body needs "canary", "shadow" or "promote"')
        out["router"] = self.engine.router.describe()
        self._send_json(200, out)


def make_http_server(engine: ServingEngine, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """Build (but do not run) the threaded HTTP server; ``port=0``
    binds an ephemeral port (``server.server_address`` has the real
    one — tests use this)."""
    handler = type("BoundServingHandler", (ServingHandler,),
                   {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(engine: ServingEngine, host: str, port: int) -> None:
    """Blocking serve loop (the CLI ``task=serve`` body)."""
    server = make_http_server(engine, host, port)
    addr = server.server_address
    log_info(f"serving on http://{addr[0]}:{addr[1]} "
             f"(model v{engine.version}, buckets "
             f"{list(engine.config.buckets)})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    finally:
        server.server_close()
        engine.stop()
