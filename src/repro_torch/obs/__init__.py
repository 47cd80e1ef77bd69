"""repro_torch.obs -- the solver telemetry fabric, the port of ``repro.obs``.

1. **Per-step metrics** (``metrics.StepMetrics``): one row of convergence
   scalars per iteration, beside the ColonyState on every route; bitwise
   neutral to the solve.
2. **Host-side spans and events** (``registry.Registry``,
   ``trace.Tracer``, ``trace.EventLog``): counters, gauges and bounded
   histograms the services' ``stats`` read from, wall-clock spans on
   per-bucket tracks, and a JSON-lines lifecycle event log.
3. **Export surfaces**: Chrome-trace (Perfetto-loadable) timelines,
   ``repro.obs/v1`` metrics snapshots, and ``torch.profiler`` captures.
4. **Serving plane** (``serving``): per-tenant SLO accounting
   (``SloTracker``), the Prometheus text renderer and the ``MetricsServer``
   endpoint; ``validate`` holds the schema checks of traces and event logs.

``Telemetry`` bundles one registry, tracer and event log; the services
take an optional instance and default to a private in-memory one.
"""
from __future__ import annotations

from typing import Optional

from . import metrics, registry, serving, trace, validate
from .metrics import StepMetrics
from .registry import Registry
from .serving import MetricsServer, SloTracker, render_prometheus
from .trace import EventLog, Tracer

SCHEMA = "repro.obs/v1"


class Telemetry:
    """One run's bundled observability surfaces."""

    def __init__(self, events_path: Optional[str] = None,
                 max_events: int = 200_000,
                 profile_dir: Optional[str] = None) -> None:
        self.registry = Registry()
        self.tracer = Tracer(max_events=max_events)
        self.events = EventLog(events_path, max_records=max_events)
        self.profile_dir = profile_dir
        self._prof = None

    # ----------------------------------------------------- torch.profiler
    @property
    def profiling(self) -> bool:
        return self._prof is not None

    def profile_start(self) -> None:
        if self.profile_dir and self._prof is None:
            self._prof = trace.profile_start()

    def profile_stop(self) -> Optional[str]:
        """Stop a running capture; returns the Chrome trace's path."""
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        return trace.profile_stop(prof, self.profile_dir)

    def step_annotation(self, name: str, **kw):
        """A named profiler range around a chunk dispatch -- only pays when
        a capture is running."""
        return trace.step_annotation(name, enabled=self.profiling, **kw)

    # ------------------------------------------------------------ exports
    def snapshot(self, extra: Optional[dict] = None) -> dict:
        """The ``repro.obs/v1`` metrics snapshot."""
        out = {
            "schema": SCHEMA,
            "registry": self.registry.snapshot(),
            "events_dropped": self.events.dropped,
            "trace_dropped": self.tracer.dropped,
        }
        if extra:
            out.update(extra)
        return out

    def write_metrics(self, path: str, extra: Optional[dict] = None) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.snapshot(extra), f, indent=2, default=str)

    def write_trace(self, path: str) -> None:
        self.tracer.write(path)

    def close(self) -> None:
        self.profile_stop()
        self.events.close()


__all__ = ["Telemetry", "Registry", "Tracer", "EventLog", "StepMetrics",
           "MetricsServer", "SloTracker", "render_prometheus",
           "SCHEMA", "metrics", "registry", "serving", "trace", "validate"]
