"""repro_torch.obs — the metrics registry and the security audit log.

Span tracing, the live monitor and the exporters of :mod:`repro.obs`
are not ported yet; the window engine takes no ``tracer=``/``monitor=``.
"""
from repro_torch.obs.audit import AuditEvent, AuditLog
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, REGISTRY,
                                     dispatch_count, reset_dispatch_count)

__all__ = ["AuditEvent", "AuditLog", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "REGISTRY", "dispatch_count",
           "reset_dispatch_count"]
