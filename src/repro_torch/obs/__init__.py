"""repro_torch.obs — unified telemetry: tracing, metrics, audit, live health.

The port's own copy of :mod:`repro.obs`, five planes in one subsystem:

* :mod:`repro_torch.obs.trace`   — per-window span tracing
  (:class:`Tracer`, off by default via :data:`NULL_TRACER`), Chrome-trace
  JSON export;
* :mod:`repro_torch.obs.metrics` — the process-wide :data:`REGISTRY` of
  named counters/gauges/histograms and the wrapper-level
  :func:`dispatch_count`;
* :mod:`repro_torch.obs.audit`   — the append-only security event stream
  owned by each :class:`repro_torch.attest.KeyDirectory`;
* :mod:`repro_torch.obs.monitor` — :class:`PipelineMonitor` sliding-window
  stage health + the SLO/stall :class:`Watchdog`;
* :mod:`repro_torch.obs.export`  — Prometheus/JSON exporters and the
  stdlib HTTP scrape endpoint (:func:`serve_metrics`).
"""
from repro_torch.obs.audit import AuditEvent, AuditLog
from repro_torch.obs.export import (MetricsServer, prometheus_text,
                                    serve_metrics, snapshot_json)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, REGISTRY,
                                     dispatch_count, reset_dispatch_count)
from repro_torch.obs.monitor import (Breach, NULL_MONITOR, NullMonitor,
                                     PipelineMonitor, SLORule, Watchdog)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "AuditEvent", "AuditLog",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "dispatch_count", "reset_dispatch_count",
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "Breach", "NULL_MONITOR", "NullMonitor", "PipelineMonitor",
    "SLORule", "Watchdog",
    "MetricsServer", "prometheus_text", "serve_metrics", "snapshot_json",
]
