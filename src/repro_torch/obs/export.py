"""Exporters: Prometheus text exposition + JSON snapshots over HTTP.

The port's own copy of the reference exporters.  Renders any
:class:`~repro_torch.obs.monitor.PipelineMonitor` snapshot and the
process-wide :data:`~repro_torch.obs.metrics.REGISTRY` in two formats:

* :func:`prometheus_text` — the Prometheus text exposition format
  (version 0.0.4): stage-scoped series carry a ``stage="..."`` label
  (``repro_stage_windows_per_second{stage="sgx_mapper"}``), registry
  histograms export as summaries with ``quantile`` labels, and every
  registry instrument flattens to a sanitized ``repro_*`` name;
* :func:`snapshot_json` — the monitor snapshot + registry dump as one
  JSON-ready dict (what CI uploads next to the bench artifacts).

:func:`serve_metrics` serves both from a stdlib ``http.server`` thread —
``/metrics`` (Prometheus), ``/health`` (liveness + watchdog verdict),
``/snapshot`` (JSON) — so a running pipeline is scrapeable with zero
third-party dependencies.  ``port=0`` binds an ephemeral port (tests);
the returned :class:`MetricsServer` exposes ``.port``/``.url`` and
``.stop()``, and works as a context manager.  The HTTP thread reads only
the registry and the monitor's host-side numbers: it makes no CUDA call.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import REGISTRY, Counter, Gauge, Histogram
from repro_torch.obs.monitor import NULL_MONITOR

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_STAGE_RE = re.compile(r"^pipeline\.stage\.(?P<stage>.+)\.(?P<metric>[^.]+)$")

#: monitor stage-stat key -> (prometheus metric suffix, HELP text)
_STAGE_STATS = (
    ("windows_per_s", "windows_per_second",
     "Sliding-window stage throughput in windows/s"),
    ("rows_per_s", "rows_per_second",
     "Sliding-window stage throughput in rows/s"),
    ("mbps", "mbytes_per_second",
     "Sliding-window stage plaintext throughput in MB/s"),
    ("p50_s", "window_latency_p50_seconds",
     "Sliding-window p50 per-window stage latency"),
    ("p95_s", "window_latency_p95_seconds",
     "Sliding-window p95 per-window stage latency"),
    ("queue_rows", "queue_rows",
     "Rows buffered at the stage boundary (last window)"),
    ("worker_skew", "worker_skew",
     "Max/mean per-worker row share over the sliding window (1.0=even)"),
    ("mac_failure_rate", "mac_failure_rate",
     "Fraction of rows failing MAC verification (sliding window)"),
    ("dispatches_per_window", "dispatches_per_window",
     "Compiled-program launches per window at this hop"),
    ("epoch_lag", "epoch_lag",
     "Directory epoch minus the stage's oldest in-flight epoch"),
)


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _label(value: str) -> str:
    """Escape a Prometheus label value."""
    return value.replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")


def _fmt(v: Any) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(registry=None, monitor=None) -> str:
    """Render the registry + monitor snapshot as Prometheus text
    exposition (format version 0.0.4)."""
    registry = REGISTRY if registry is None else registry
    monitor = NULL_MONITOR if monitor is None else monitor
    lines: List[str] = []

    def head(name: str, kind: str, help_: str) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")

    # ---- registry instruments: stage-scoped names become labeled series
    stage_series: Dict[str, List] = {}
    flat: List = []
    for name in registry.names():
        inst = registry.get(name)
        m = _STAGE_RE.match(name)
        if m:
            key = m.group("metric")
            stage_series.setdefault(key, []).append(
                (m.group("stage"), inst))
        else:
            flat.append((name, inst))

    for key in sorted(stage_series):
        entries = stage_series[key]
        kind = ("counter" if isinstance(entries[0][1], Counter)
                else "gauge" if isinstance(entries[0][1], Gauge)
                else "summary")
        base = f"repro_pipeline_stage_{_sanitize(key)}"
        head(base, kind, f"Registry instrument pipeline.stage.*.{key}")
        for stage, inst in entries:
            lab = f'stage="{_label(stage)}"'
            if isinstance(inst, Histogram):
                for q in (50, 95, 99):
                    lines.append(
                        f'{base}{{{lab},quantile="{q / 100}"}} '
                        f"{_fmt(inst.percentile(q))}")
                lines.append(f"{base}_count{{{lab}}} {inst.count}")
                lines.append(f"{base}_sum{{{lab}}} {_fmt(inst.total)}")
            else:
                lines.append(f"{base}{{{lab}}} {_fmt(inst.value)}")

    for name, inst in flat:
        base = f"repro_{_sanitize(name)}"
        if isinstance(inst, Histogram):
            head(base, "summary", f"Registry histogram {name}")
            for q in (50, 95, 99):
                lines.append(f'{base}{{quantile="{q / 100}"}} '
                             f"{_fmt(inst.percentile(q))}")
            lines.append(f"{base}_count {inst.count}")
            lines.append(f"{base}_sum {_fmt(inst.total)}")
        else:
            kind = "counter" if isinstance(inst, Counter) else "gauge"
            head(base, kind, f"Registry {kind} {name}")
            lines.append(f"{base} {_fmt(inst.value)}")

    # ---- monitor sliding-window stage health
    snap = monitor.snapshot() if getattr(monitor, "enabled", False) else None
    if snap and snap["stages"]:
        for key, suffix, help_ in _STAGE_STATS:
            base = f"repro_stage_{suffix}"
            head(base, "gauge", help_)
            for stage in sorted(snap["stages"]):
                stats = snap["stages"][stage]
                if stats is None or stats.get(key) is None:
                    continue
                lines.append(
                    f'{base}{{stage="{_label(stage)}"}} '
                    f"{_fmt(stats[key])}")
    if snap:
        # "repro_monitor_", not "repro_pipeline_": the snapshot mirrors
        # registry totals (host_syncs, dispatches) whose flat names
        # already own the repro_pipeline_*/repro_device_* namespace.
        for key, v in sorted(snap["pipeline"].items()):
            if isinstance(v, dict):
                # nested group (e.g. "ft": fault-tolerance totals) —
                # flatten to repro_monitor_<group>_<metric>
                for sub, sv in sorted(v.items()):
                    base = f"repro_monitor_{_sanitize(key)}_" \
                           f"{_sanitize(sub)}"
                    head(base, "gauge", f"Pipeline-wide {key}.{sub}")
                    lines.append(f"{base} {_fmt(sv)}")
                continue
            base = f"repro_monitor_{_sanitize(key)}"
            head(base, "gauge", f"Pipeline-wide {key}")
            lines.append(f"{base} {_fmt(v)}")
        wd = snap.get("watchdog")
        if wd is not None:
            head("repro_slo_breached", "gauge",
                 "1 while any watchdog SLO rule is latched breached")
            lines.append(
                f"repro_slo_breached {1 if wd['breached'] else 0}")
    return "\n".join(lines) + "\n"


def snapshot_json(monitor=None, registry=None) -> Dict[str, Any]:
    """The monitor snapshot + registry dump as one JSON-ready dict."""
    registry = REGISTRY if registry is None else registry
    monitor = NULL_MONITOR if monitor is None else monitor
    return {"monitor": monitor.snapshot(), "registry": registry.snapshot()}


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-metrics/1"

    def do_GET(self):                                   # noqa: N802
        mon = self.server.monitor                       # type: ignore
        reg = self.server.registry                      # type: ignore
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = prometheus_text(reg, mon).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/health":
            breaches = mon.check() if getattr(mon, "enabled", False) else []
            snap = mon.snapshot()
            wd = snap.get("watchdog")
            latched = wd["breached"] if wd else []
            status = "ok"
            if any(b.kind == "stall" for b in breaches) or \
                    any("stall" in r for r in latched):
                status = "stalled"
            elif latched:
                status = "degraded"
            body = json.dumps({
                "status": status, "breached": latched,
                "windows_total": snap["pipeline"].get("windows_total", 0),
                "uptime_s": snap["pipeline"].get("uptime_s"),
            }).encode()
            ctype = "application/json"
        elif path == "/snapshot":
            body = json.dumps(snapshot_json(mon, reg), indent=1).encode()
            ctype = "application/json"
        else:
            self.send_error(404, "try /metrics, /health or /snapshot")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):                  # silence stderr
        return None


class MetricsServer:
    """A scrape endpoint on a daemon thread; ``port=0`` = ephemeral."""

    def __init__(self, monitor=None, registry=None,
                 host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.monitor = NULL_MONITOR if monitor is None else monitor
        self._httpd.registry = REGISTRY if registry is None else registry
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def serve_metrics(port: int = 0, monitor=None, registry=None,
                  host: str = "127.0.0.1") -> MetricsServer:
    """Start serving ``/metrics``, ``/health`` and ``/snapshot`` on a
    daemon thread; returns the running :class:`MetricsServer`."""
    return MetricsServer(monitor=monitor, registry=registry,
                         host=host, port=port)
