"""Serving observability plane: per-tenant SLO accounting + exposition.

The port's copy of ``repro.obs.serving``, which imports no JAX: the port
imports nothing of the reference, so it keeps its own.

The telemetry fabric (DESIGN.md §13) records everything in-process; this
module (§14) is the layer that makes a *serving* deployment observable
from the outside:

- ``SloTracker`` — folds per-request outcomes (admitted / rejected /
  expired-waiting / expired-running / completed, queue wait, end-to-end
  latency vs. deadline) into per-**tenant** labeled registry families:
  counters, bounded latency histograms, and an SLO-attainment gauge
  (fraction of terminated requests that completed within their deadline).
  The solver services call its hooks on every lifecycle transition; its
  ``summary()`` rides ``stats_snapshot`` events and service ``stats``.
- ``render_prometheus`` — the registry snapshot as Prometheus text
  exposition format (counters/gauges as-is, histograms as summaries with
  ``quantile`` labels plus ``_sum``/``_count``/``_max`` series).
- ``MetricsServer`` — a stdlib ``http.server`` background thread serving
  ``GET /metrics`` (Prometheus text), ``/healthz`` (pool liveness +
  occupancy JSON), and ``/snapshot`` (the ``repro.obs/v1`` JSON).  Wired
  into the services by ``solve_serve --metrics-port``; ``port=0`` binds
  an ephemeral port (tests), ``server.port`` reports the bound one.

Everything here is host-side and read-only over the registry: enabling
the endpoint cannot perturb a solve (the bitwise on==off contract of
tests/test_serving.py).
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .registry import Histogram, Registry

DEFAULT_TENANT = "default"

# Outcomes a request can terminate with (the SLO denominator): completed
# normally, evicted from the waiting queue, or evicted mid-run.
TERMINAL_OUTCOMES = ("completed", "expired_waiting", "expired_running")


class SloTracker:
    """Per-tenant SLO accounting over labeled registry families.

    Hooks mirror the request lifecycle: ``on_submit`` / ``on_reject`` at
    admission control, ``on_admit`` when a waiting request enters a slot
    (records queue wait), ``on_outcome`` at any terminal transition
    (records e2e latency and whether the deadline — when the request had
    one — was met).  Attainment is ``met / terminated`` where a request
    is *met* iff it completed and either had no deadline or finished
    within it; expired requests always count against attainment.
    """

    def __init__(self, registry: Registry, window: int = 2048) -> None:
        self.registry = registry
        self.window = window
        self._tenants: set[str] = set()

    @staticmethod
    def tenant_label(tenant: Optional[str]) -> str:
        return tenant if tenant else DEFAULT_TENANT

    @property
    def tenants(self) -> set:
        """Tenant labels seen so far (normalized)."""
        return set(self._tenants)

    def _c(self, name: str, tenant: str):
        return self.registry.counter(name, tenant=tenant)

    # ---------------------------------------------------------- lifecycle
    def on_submit(self, tenant: Optional[str]) -> str:
        t = self.tenant_label(tenant)
        self._tenants.add(t)
        self._c("slo_submitted", t).inc()
        return t

    def on_reject(self, tenant: Optional[str]) -> None:
        t = self.tenant_label(tenant)
        self._tenants.add(t)
        self._c("slo_rejected", t).inc()

    def on_admit(self, tenant: Optional[str], wait_s: float) -> None:
        t = self.tenant_label(tenant)
        self._c("slo_admitted", t).inc()
        self.registry.histogram("slo_queue_wait_s", window=self.window,
                                tenant=t).observe(wait_s)

    def on_outcome(self, tenant: Optional[str], outcome: str,
                   latency_s: float, deadline: Optional[float]) -> None:
        if outcome not in TERMINAL_OUTCOMES:
            raise ValueError(f"unknown terminal outcome {outcome!r}; "
                             f"one of {TERMINAL_OUTCOMES}")
        t = self.tenant_label(tenant)
        self._tenants.add(t)
        self._c(f"slo_{outcome}", t).inc()
        self._c("slo_terminated", t).inc()
        self.registry.histogram("slo_latency_s", window=self.window,
                                tenant=t).observe(latency_s)
        met = (outcome == "completed"
               and (deadline is None or latency_s <= deadline))
        if met:
            self._c("slo_met", t).inc()
        terminated = self._c("slo_terminated", t).value
        self.registry.gauge("slo_attainment", tenant=t).set(
            self._c("slo_met", t).value / terminated if terminated else 1.0)

    # ------------------------------------------------------------ summary
    def summary(self) -> dict:
        """Per-tenant SLO view (rides ``stats_snapshot`` events and the
        services' ``stats``): counters, attainment, and the bounded
        queue-wait / latency histogram summaries."""
        out: dict[str, dict] = {}
        for t in sorted(self._tenants):
            row = {
                "submitted": self._c("slo_submitted", t).value,
                "rejected": self._c("slo_rejected", t).value,
                "admitted": self._c("slo_admitted", t).value,
                "completed": self._c("slo_completed", t).value,
                "expired_waiting": self._c("slo_expired_waiting", t).value,
                "expired_running": self._c("slo_expired_running", t).value,
                "terminated": self._c("slo_terminated", t).value,
                "met": self._c("slo_met", t).value,
                "attainment": self.registry.gauge("slo_attainment",
                                                  tenant=t).value,
                "queue_wait_s": self.registry.histogram(
                    "slo_queue_wait_s", window=self.window,
                    tenant=t).summary(),
                "latency_s": self.registry.histogram(
                    "slo_latency_s", window=self.window,
                    tenant=t).summary(),
            }
            out[t] = row
        return out


# -------------------------------------------------------------- exposition
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")

QUANTILES = (50.0, 95.0, 99.0)


def _metric_name(name: str, prefix: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return prefix + name


def _label_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(
        f'{_LABEL_RE.sub("_", str(k))}="{_escape(str(v))}"'
        for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(registry: Registry, prefix: str = "repro_") -> str:
    """Render the registry as Prometheus text exposition format 0.0.4.

    Counters/gauges map directly; each ``Histogram`` renders as a summary
    — ``name{quantile="0.5"}`` lines from the bounded sample window plus
    exact ``name_sum`` / ``name_count`` / ``name_max`` series (DESIGN.md
    §13: sums and counts never drift, quantiles are recent-window).
    ``# TYPE`` headers are emitted once per family name.
    """
    lines: list[str] = []
    typed: set[str] = set()

    def header(mname: str, kind: str) -> None:
        if mname not in typed:
            typed.add(mname)
            lines.append(f"# TYPE {mname} {kind}")

    for name, labels, kind, inst in registry.families():
        mname = _metric_name(name, prefix)
        if kind == "counter":
            header(mname, "counter")
            lines.append(f"{mname}{_label_str(labels)} {inst.value}")
        elif kind == "gauge":
            header(mname, "gauge")
            lines.append(f"{mname}{_label_str(labels)} {_fmt(inst.value)}")
        else:                                   # histogram -> summary
            assert isinstance(inst, Histogram)
            header(mname, "summary")
            for q in QUANTILES:
                ls = _label_str(labels, {"quantile": q / 100.0})
                lines.append(f"{mname}{ls} {_fmt(inst.percentile(q))}")
            lines.append(f"{mname}_sum{_label_str(labels)} "
                         f"{_fmt(inst.total)}")
            lines.append(f"{mname}_count{_label_str(labels)} {inst.count}")
            header(f"{mname}_max", "gauge")
            lines.append(f"{mname}_max{_label_str(labels)} "
                         f"{_fmt(inst.max())}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- endpoint
class MetricsServer:
    """Background-thread HTTP exposition endpoint over one Telemetry.

    Routes:

    - ``GET /metrics``  — Prometheus text (``render_prometheus``);
    - ``GET /healthz``  — JSON: ``{"ok": true, "uptime_s": ...}`` merged
      with the service's ``health()`` view (pool liveness + occupancy);
    - ``GET /snapshot`` — the ``repro.obs/v1`` JSON
      (``Telemetry.snapshot()``, plus ``snapshot_extra_fn()`` fields).

    All handlers are read-only over host-side state, served by a
    ``ThreadingHTTPServer`` daemon thread: scraping cannot block or
    perturb the solve loop.  ``port=0`` binds an ephemeral port; the
    bound one is ``self.port``.  ``close()`` is idempotent.
    """

    def __init__(self, telemetry, health_fn: Optional[Callable] = None,
                 snapshot_extra_fn: Optional[Callable] = None,
                 port: int = 0, host: str = "127.0.0.1") -> None:
        self.telemetry = telemetry
        self.health_fn = health_fn
        self.snapshot_extra_fn = snapshot_extra_fn
        self._t0 = time.monotonic()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):          # keep stdout clean
                pass

            def do_GET(self):                   # noqa: N802 (http.server)
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = render_prometheus(
                            outer.telemetry.registry).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/healthz":
                        health = {"ok": True,
                                  "uptime_s": time.monotonic() - outer._t0}
                        if outer.health_fn is not None:
                            health.update(outer.health_fn())
                        body = json.dumps(health).encode()
                        ctype = "application/json"
                    elif path == "/snapshot":
                        extra = (outer.snapshot_extra_fn()
                                 if outer.snapshot_extra_fn else None)
                        body = json.dumps(outer.telemetry.snapshot(extra),
                                          default=str).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass
                except Exception as e:          # surface, don't crash
                    try:
                        self.send_error(500, str(e))
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-metrics-server",
            daemon=True)
        self._thread.start()

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=5)
            self._server = None
