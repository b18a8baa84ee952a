"""Live ops HTTP endpoint: /metrics /healthz /varz /requestz
/profilez /stallz (the port of `incubator_mxnet_tpu/telemetry/http.py`).

`TelemetryServer` is a stdlib ``ThreadingHTTPServer`` (no new
dependencies) that serves the live registry while the process runs, so
counters and traces do not reach disk only via ``telemetry.dump()`` at
exit:

* ``/metrics``  — `exporters.prometheus_text` with the scrape content
  type ``text/plain; version=0.0.4`` (what a Prometheus scraper
  negotiates for the text exposition format);
* ``/healthz``  — aggregate of registered health providers; JSON body
  with per-provider detail, HTTP 200 while ``healthy``/``degraded``
  and 503 once any provider reports ``unhealthy`` (load balancers key
  on the status code; the degraded state is a body-level warning, not
  an eviction);
* ``/varz``     — JSON snapshot of every metric (name, labels, value /
  histogram summary) under ``"metrics"``, plus a ``"config"`` section
  of registered build/config providers (the serving engine publishes
  kv_dtype, attn_impl, batch/bucket geometry, SLO targets and the
  MXTPU_* env knobs — so ops triage can tell WHICH configuration is
  running, not just how it is doing) and ``"perf"``, the device the
  program rates are taken against and its peaks (or why there are no
  MFU / roofline gauges);
* ``/requestz`` — recent completed request traces (the
  `telemetry.requestlog` ring) plus each registered provider's
  in-flight table;
* ``/profilez`` — on-demand merged chrome-trace capture
  (``?seconds=N``, default 1, bounded; see `telemetry.profiler`) —
  request, scheduler, program, GC and lock lanes in one JSON a
  Perfetto / chrome://tracing load renders directly;
* ``/stallz``   — per-engine stall attribution: aggregate cause table
  + the worst recent hiccup records with their per-cause ledgers.

Providers are ``name -> callable`` registries (the serving engine
registers itself; anything else can too).  Provider callbacks run on
HTTP handler threads — they must be cheap, lock briefly, and never
touch the device.  A raising provider is reported as ``unhealthy``
with the error string rather than taking the endpoint down.

Lifecycle: ``MXTPU_TELEMETRY_PORT`` env-gates `start_from_env()`
(port 0 = ephemeral, the test/CI default — read the bound port back
from ``server.port``).  `close()` shuts the socket down and JOINS the
acceptor thread; handler threads are daemonic and
bounded by request lifetime.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs

from . import exporters, requestlog
from .registry import Histogram, Registry

__all__ = ["TelemetryServer", "start_from_env", "HEALTH_ORDER"]

# worst-wins aggregation order for /healthz
HEALTH_ORDER = ("healthy", "degraded", "unhealthy")


def _worst(statuses) -> str:
    rank = {s: i for i, s in enumerate(HEALTH_ORDER)}
    worst = "healthy"
    for s in statuses:
        if rank.get(s, len(HEALTH_ORDER)) >= rank.get(worst, 0):
            worst = s if s in rank else "unhealthy"
    return worst


def _varz(registry: Registry) -> dict:
    out = {}
    for m in registry.metrics():
        key = m.name
        if m.labels:
            inner = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
            key = f"{m.name}{{{inner}}}"
        snap = m.snapshot()
        if isinstance(m, Histogram):
            # /varz is a human/debug view: summary, not raw buckets
            snap = {k: v for k, v in snap.items()
                    if k not in ("buckets", "bounds")}
        out[key] = {"type": m.kind, **snap}
    return out


class _Handler(BaseHTTPRequestHandler):
    # the acceptor owns the server object; self.server is the
    # ThreadingHTTPServer we attach the TelemetryServer to
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: CI parses stdout
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, indent=1, default=str)
                   .encode("utf-8"), "application/json")

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        owner: "TelemetryServer" = self.server._owner
        raw_path, _, query = self.path.partition("?")
        path = raw_path.rstrip("/") or "/"
        try:
            if path == "/metrics":
                from . import perf

                perf.resolve()
                body = exporters.prometheus_text(owner.registry)
                self._send(200, body.encode("utf-8"),
                           exporters.PROM_CONTENT_TYPE)
            elif path == "/healthz":
                health = owner.health()
                code = 503 if health["status"] == "unhealthy" else 200
                self._send_json(code, health)
            elif path == "/varz":
                self._send_json(200, owner.varz())
            elif path == "/requestz":
                self._send_json(200, owner.requestz())
            elif path == "/profilez":
                from . import profiler

                try:
                    seconds = float(
                        parse_qs(query).get("seconds", ["1"])[0])
                except ValueError:
                    self._send_json(400, {"error": "bad seconds= value"})
                    return
                # traces are big — no indent (the capture itself sleeps
                # on this handler thread; bounded by MAX_CAPTURE_S)
                body = json.dumps(profiler.capture(seconds),
                                  default=str).encode("utf-8")
                self._send(200, body, "application/json")
            elif path == "/stallz":
                from . import profiler

                self._send_json(200, profiler.stallz())
            elif path == "/":
                self._send_json(200, {"endpoints": [
                    "/metrics", "/healthz", "/varz", "/requestz",
                    "/profilez", "/stallz"]})
            else:
                self._send_json(404, {"error": f"no endpoint {path!r}"})
        except Exception as e:  # a broken provider must not kill serving
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass


class TelemetryServer:
    """The ops endpoint server; one per process is the normal shape
    (the serving engine starts it when ``MXTPU_TELEMETRY_PORT`` is
    set, or when constructed with ``http_port=``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[Registry] = None):
        from . import get_registry

        self.registry = registry if registry is not None else get_registry()
        self._providers_lock = threading.Lock()
        self._health_providers: Dict[str, Callable[[], dict]] = {}
        self._requestz_providers: Dict[str, Callable[[], dict]] = {}
        self._varz_providers: Dict[str, Callable[[], dict]] = {}
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._owner = self
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True, name="mxtpu-telemetry-http")
        self._thread.start()

    # -- provider registry --------------------------------------------- #
    def register_health(self, name: str,
                        fn: Callable[[], dict]) -> None:
        """``fn() -> {"status": healthy|degraded|unhealthy, ...}``."""
        with self._providers_lock:
            self._health_providers[name] = fn

    def register_requestz(self, name: str,
                          fn: Callable[[], dict]) -> None:
        """``fn() -> {"in_flight": [...], ...}`` (per-provider table)."""
        with self._providers_lock:
            self._requestz_providers[name] = fn

    def register_varz(self, name: str,
                      fn: Callable[[], dict]) -> None:
        """``fn() -> {...}`` build/config facts for `/varz`'s
        ``config`` section (frozen engine geometry, env knobs)."""
        with self._providers_lock:
            self._varz_providers[name] = fn

    def unregister(self, name: str) -> None:
        with self._providers_lock:
            self._health_providers.pop(name, None)
            self._requestz_providers.pop(name, None)
            self._varz_providers.pop(name, None)

    # -- endpoint payloads (also callable in-process, for tests) ------- #
    def health(self) -> dict:
        with self._providers_lock:
            providers = dict(self._health_providers)
        checks = {}
        for name, fn in sorted(providers.items()):
            try:
                checks[name] = fn()
            except Exception as e:
                checks[name] = {"status": "unhealthy",
                                "error": f"{type(e).__name__}: {e}"}
        status = _worst(c.get("status", "unhealthy")
                        for c in checks.values())
        return {"status": status, "checks": checks}

    def varz(self) -> dict:
        """The `/varz` payload: the metric snapshot under ``metrics``
        plus each registered provider's build/config facts under
        ``config`` (a raising provider reports its error string)."""
        from . import perf

        perf.resolve()
        with self._providers_lock:
            providers = dict(self._varz_providers)
        config = {}
        for name, fn in sorted(providers.items()):
            try:
                config[name] = fn()
            except Exception as e:
                config[name] = {"error": f"{type(e).__name__}: {e}"}
        return {"metrics": _varz(self.registry), "config": config,
                "perf": perf.varz_section()}

    def requestz(self) -> dict:
        with self._providers_lock:
            providers = dict(self._requestz_providers)
        engines = {}
        for name, fn in sorted(providers.items()):
            try:
                engines[name] = fn()
            except Exception as e:
                engines[name] = {"error": f"{type(e).__name__}: {e}"}
        ring = requestlog.ring()
        return {"engines": engines,
                "ring": {"cap": ring.cap, "pushed": ring.pushed},
                "recent": ring.recent()}

    # -- lifecycle ----------------------------------------------------- #
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop accepting, close the socket, JOIN the acceptor thread
        (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout)

    def __enter__(self) -> "TelemetryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_from_env(registry: Optional[Registry] = None
                   ) -> Optional[TelemetryServer]:
    """Start a server iff ``MXTPU_TELEMETRY_PORT`` is set (0 =
    ephemeral port); returns None otherwise.  A bind failure (port
    taken — e.g. a second engine in the same process) returns None
    rather than raising: the ops plane is best-effort, the serving
    plane must not die for it."""
    port = os.environ.get("MXTPU_TELEMETRY_PORT", "")
    if port == "":
        return None
    try:
        return TelemetryServer(port=int(port), registry=registry)
    except OSError:
        return None
