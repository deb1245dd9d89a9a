"""Live pipeline health: sliding-window stage stats + SLO watchdog.

The port's own copy of the reference monitor.
:class:`PipelineMonitor` watches a *running* pipeline — where the
:data:`~repro_torch.obs.metrics.REGISTRY` instruments and the
:class:`~repro_torch.obs.audit.AuditLog` accumulate lifetime totals, the
monitor maintains **sliding-window** aggregates (windows/s, MB/s,
p50/p95 window latency, queue depth, per-worker row-count skew,
mac-failure and rekey/eviction rates, epoch lag), updated once per
window by a single ``record_window`` call from the engine.  That is the
live feedback signal the ROADMAP's elastic-autoscaling controller needs,
and it is what the exporters in :mod:`repro_torch.obs.export` serve over
HTTP.

Cost model mirrors the tracer: the engine holds :data:`NULL_MONITOR`
(``enabled=False``) unless a real monitor is attached, so the disabled
path is one attribute check per window.  Enabled, each record is a deque
append plus O(window) evictions over host-side numbers the engine has
already (the window's numpy verdicts, row counts, epochs): it adds no
device work and no host sync.

:class:`Watchdog` evaluates declarative :class:`SLORule` limits (max p95
latency, min throughput, max queue depth, mac-failure-rate ceiling, and
stall = no window progress for T seconds) against the monitor's sliding
stats.  A rule fires its ordered callbacks ONCE per breach — it re-arms
only after the condition recovers — and writes the matching
``slo_breach``/``stall`` event into the audit log, so breaches land in
the same ordered security stream as rekeys and revocations.  Clocks are
injectable (``clock=``) so stalls are testable without sleeping.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.obs.audit import AuditLog
from repro_torch.obs.metrics import REGISTRY


class NullMonitor:
    """The disabled monitor: every operation is a no-op.

    ``enabled`` is False so the engine skips even building the per-window
    kwargs; a NullMonitor never allocates.
    """

    enabled = False

    def attach(self, pipeline) -> None:
        return None

    def record_window(self, stage: str, **kw) -> None:
        return None

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        return {"stages": {}, "pipeline": {}, "watchdog": None}


#: The module-wide disabled monitor the engine defaults to.
NULL_MONITOR = NullMonitor()


class _StageWindow:
    """Sliding-window aggregates for one stage (or ingress/egress hop)."""

    __slots__ = ("samples", "rows", "ok_rows", "bytes", "seconds",
                 "dispatches", "worker_rows", "queue_rows", "epoch_lag",
                 "total_windows", "total_rows")

    def __init__(self):
        # each sample: (t, rows, ok_rows, bytes, seconds, dispatches,
        #               worker_rows-dict-or-None)
        self.samples: deque = deque()
        self.rows = 0                 # running sums over the deque
        self.ok_rows = 0
        self.bytes = 0
        self.seconds = 0.0
        self.dispatches = 0
        self.worker_rows: Dict[Any, int] = {}
        self.queue_rows: Optional[int] = None     # last observed
        self.epoch_lag: Optional[int] = None      # last observed
        self.total_windows = 0                    # lifetime
        self.total_rows = 0

    def add(self, t, rows, ok_rows, nbytes, seconds, dispatches, wrows):
        self.samples.append((t, rows, ok_rows, nbytes, seconds,
                             dispatches, wrows))
        self.rows += rows
        self.ok_rows += ok_rows
        self.bytes += nbytes
        self.seconds += seconds
        self.dispatches += dispatches
        if wrows:
            for w, r in wrows.items():
                self.worker_rows[w] = self.worker_rows.get(w, 0) + r
        self.total_windows += 1
        self.total_rows += rows

    def evict(self, cutoff: float, max_samples: int) -> None:
        q = self.samples
        while q and (q[0][0] < cutoff or len(q) > max_samples):
            t, rows, ok, nb, sec, disp, wrows = q.popleft()
            self.rows -= rows
            self.ok_rows -= ok
            self.bytes -= nb
            self.seconds -= sec
            self.dispatches -= disp
            if wrows:
                for w, r in wrows.items():
                    left = self.worker_rows.get(w, 0) - r
                    if left > 0:
                        self.worker_rows[w] = left
                    else:
                        self.worker_rows.pop(w, None)


class PipelineMonitor:
    """Per-stage sliding-window health, updated once per window.

    The engine calls :meth:`record_window` after each stage round (and
    for the ingress/egress hops under the pseudo-stage names
    ``"ingress"``/``"egress"``); everything else — audit-event rates,
    epoch lag, watchdog checks — piggybacks on that call, so a monitored
    run adds no extra host syncs and no background threads.

    ``window_seconds`` is the sliding horizon; ``max_samples`` bounds
    memory per stage regardless of rate.  ``clock`` is injectable for
    tests (defaults to ``time.monotonic``).
    """

    enabled = True

    def __init__(self, window_seconds: float = 60.0,
                 max_samples: int = 512,
                 clock: Optional[Callable[[], float]] = None):
        self.window_seconds = float(window_seconds)
        self.max_samples = int(max_samples)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()     # snapshot() runs on HTTP threads
        self._stages: Dict[str, _StageWindow] = {}
        self._t0 = self._clock()
        self.last_progress = self._t0     # last record_window of any stage
        self.windows_total = 0
        self._audit: Optional[AuditLog] = None
        self._audit_seen = 0              # next unseen audit seq
        self._audit_times: Dict[str, deque] = {}
        self._directory = None            # epoch source (may stay None)
        self._watchdogs: List["Watchdog"] = []

    # ----------------------------------------------------------- attachment

    def attach(self, pipeline) -> None:
        """Bind to a pipeline's key directory (audit log + epoch source).

        Re-attaching to another pipeline re-binds the audit stream; the
        sliding stats continue (useful across ``scale_stage`` rebuilds).
        """
        directory = getattr(pipeline, "directory", None)
        with self._lock:
            self._directory = directory
            audit = getattr(directory, "audit", None)
            if audit is not self._audit:
                self._audit = audit
                self._audit_seen = audit._seq if audit is not None else 0
            self.last_progress = self._clock()

    def watch(self, watchdog: "Watchdog") -> "Watchdog":
        self._watchdogs.append(watchdog)
        return watchdog

    # ------------------------------------------------------------ recording

    def record_window(self, stage: str, *, rows: int, ok_rows:
                      Optional[int] = None, bytes: int = 0,
                      seconds: float = 0.0, queue_rows:
                      Optional[int] = None, worker_rows:
                      Optional[Dict[Any, int]] = None,
                      min_epoch: Optional[int] = None,
                      dispatches: int = 0) -> None:
        """Fold one completed window into the stage's sliding stats."""
        now = self._clock()
        ok = rows if ok_rows is None else ok_rows
        with self._lock:
            sw = self._stages.get(stage)
            if sw is None:
                sw = self._stages[stage] = _StageWindow()
            sw.add(now, rows, ok, bytes, seconds, dispatches, worker_rows)
            sw.evict(now - self.window_seconds, self.max_samples)
            if queue_rows is not None:
                sw.queue_rows = queue_rows
            if min_epoch is not None and self._directory is not None:
                sw.epoch_lag = int(self._directory.epoch) - int(min_epoch)
            self.last_progress = now
            self.windows_total += 1
            self._ingest_audit(now)
        for wd in self._watchdogs:
            wd.check(now)

    def _ingest_audit(self, now: float) -> None:
        """Stamp newly appended audit events with their arrival time so
        per-kind rates can slide (AuditEvents carry order, not time)."""
        log = self._audit
        if log is not None and log._seq != self._audit_seen:
            for ev in log.events():
                if ev.seq >= self._audit_seen:
                    self._audit_times.setdefault(ev.kind,
                                                 deque()).append(now)
            self._audit_seen = log._seq
        cutoff = now - self.window_seconds
        for q in self._audit_times.values():
            while q and (q[0] < cutoff or len(q) > self.max_samples):
                q.popleft()

    # -------------------------------------------------------------- queries

    def _span(self, now: float) -> float:
        """The effective averaging horizon: elapsed time since attach,
        clamped to the sliding window and away from zero."""
        return max(min(now - self._t0, self.window_seconds), 1e-9)

    def stage_stats(self, stage: str,
                    now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Sliding-window stats for one stage; None before its first
        window."""
        now = self._clock() if now is None else now
        with self._lock:
            return self._stage_stats_locked(stage, now)

    def _stage_stats_locked(self, stage, now):
        sw = self._stages.get(stage)
        if sw is None:
            return None
        sw.evict(now - self.window_seconds, self.max_samples)
        span = self._span(now)
        n = len(sw.samples)
        secs = sorted(s[4] for s in sw.samples)

        def pct(q):
            if not secs:
                return None
            return secs[min(n - 1, int(round(q / 100.0 * (n - 1))))]

        skew = None
        if sw.worker_rows:
            per_w = list(sw.worker_rows.values())
            mean = sum(per_w) / len(per_w)
            skew = (max(per_w) / mean) if mean else None
        return {
            "windows": n,
            "windows_total": sw.total_windows,
            "windows_per_s": n / span,
            "rows_per_s": sw.rows / span,
            "mbps": (sw.bytes / span) / 1e6,
            "p50_s": pct(50),
            "p95_s": pct(95),
            "queue_rows": sw.queue_rows,
            "worker_rows": dict(sw.worker_rows),
            "worker_skew": skew,
            "mac_failures": sw.rows - sw.ok_rows,
            "mac_failure_rate": ((sw.rows - sw.ok_rows) / sw.rows)
            if sw.rows else 0.0,
            "dispatches": sw.dispatches,
            "dispatches_per_window": (sw.dispatches / n) if n else 0.0,
            "epoch_lag": sw.epoch_lag,
        }

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Point-in-time health dict: per-stage sliding stats, pipeline-
        wide audit rates + registry totals, watchdog state. JSON-ready."""
        now = self._clock() if now is None else now
        with self._lock:
            self._ingest_audit(now)
            span = self._span(now)
            stages = {name: self._stage_stats_locked(name, now)
                      for name in self._stages}
            rates = {f"{kind}_per_s": len(q) / span
                     for kind, q in sorted(self._audit_times.items()) if q}
            host_syncs = REGISTRY.get("pipeline.host_syncs")
            dispatches = REGISTRY.get("device.dispatches")
            # fault-tolerance totals (repro_torch.ft): all zero / absent until
            # a retry policy or chaos plan is attached to a run
            ft = {}
            for short in ("retries", "failovers", "backups", "replays",
                          "worker_failures", "enroll_failures"):
                c = REGISTRY.get(f"ft.{short}")
                if c is not None:
                    ft[short] = c.value
            g = REGISTRY.get("ft.replay.retained_rows")
            if g is not None:
                ft["replay_retained_rows"] = g.value
            pipe = {
                "uptime_s": now - self._t0,
                "windows_total": self.windows_total,
                "last_progress_age_s": now - self.last_progress,
                "host_syncs": host_syncs.value if host_syncs else 0,
                "dispatches": dispatches.value if dispatches else 0,
                **({"ft": ft} if ft else {}),
                **rates,
            }
        wd = None
        if self._watchdogs:
            wd = {"rules": sum(len(w.rules) for w in self._watchdogs),
                  "breached": sorted(r for w in self._watchdogs
                                     for r in w.breached())}
        return {"t": now, "stages": stages, "pipeline": pipe,
                "watchdog": wd}

    def check(self, now: Optional[float] = None) -> List["Breach"]:
        """Run every attached watchdog (the stall path: nothing calls
        ``record_window`` during a stall, so poll this — the HTTP
        ``/health`` endpoint does)."""
        now = self._clock() if now is None else now
        out: List[Breach] = []
        for wd in self._watchdogs:
            out.extend(wd.check(now))
        return out


# ------------------------------------------------------------------ watchdog


@dataclass(frozen=True)
class SLORule:
    """One declarative service-level objective.

    Set any subset of the limit fields; the rule breaches when ANY set
    limit is crossed.  ``stage=None`` evaluates the rule against every
    stage the monitor has seen (the breach detail names the offender).
    ``stall_seconds`` is pipeline-wide: no window progressed anywhere
    for that long.
    """
    name: str
    stage: Optional[str] = None
    max_p95_seconds: Optional[float] = None
    min_windows_per_s: Optional[float] = None
    min_mbps: Optional[float] = None
    max_queue_rows: Optional[float] = None
    max_mac_failure_rate: Optional[float] = None
    stall_seconds: Optional[float] = None


@dataclass(frozen=True)
class Breach:
    """One fired SLO violation (also recorded into the audit log)."""
    rule: str
    kind: str                     # "slo_breach" | "stall"
    stage: Optional[str]
    metric: str
    value: Optional[float]
    limit: float
    t: float
    detail: Dict[str, Any] = field(default_factory=dict)


class Watchdog:
    """Evaluates :class:`SLORule` limits against a monitor's sliding
    stats; fires ordered callbacks once per breach transition.

    A rule that breaches stays latched (no repeat fire while the
    condition persists) and re-arms when a later check finds it
    recovered — "trips exactly once" per incident.  Every fire records
    the matching ``slo_breach``/``stall`` audit event into the
    pipeline's audit log (or a private one when unattached), so SLO
    violations interleave with rekeys/revocations in one ordered stream.
    """

    def __init__(self, monitor: PipelineMonitor,
                 rules: Sequence[SLORule],
                 on_breach: Sequence[Callable[[Breach], None]] = (),
                 audit: Optional[AuditLog] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.monitor = monitor
        self.rules = list(rules)
        self.on_breach = list(on_breach)
        self._audit = audit
        self._clock = clock or monitor._clock
        self._latched: Dict[str, bool] = {}
        self.fired: List[Breach] = []       # every breach ever fired
        monitor.watch(self)

    def breached(self) -> List[str]:
        """Names of rules currently latched in the breached state."""
        return [name for name, b in self._latched.items() if b]

    @property
    def audit(self) -> AuditLog:
        if self._audit is not None:
            return self._audit
        mon_audit = self.monitor._audit
        if mon_audit is not None:
            return mon_audit
        self._audit = AuditLog()            # unattached fallback
        return self._audit

    # ----------------------------------------------------------- evaluation

    def _violation(self, rule: SLORule, now: float):
        """-> (kind, stage, metric, value, limit) or None."""
        m = self.monitor
        if rule.stall_seconds is not None:
            age = now - m.last_progress
            if age > rule.stall_seconds:
                return ("stall", rule.stage, "last_progress_age_s",
                        age, rule.stall_seconds)
        stages = [rule.stage] if rule.stage is not None \
            else sorted(m._stages)
        for st in stages:
            stats = m.stage_stats(st, now)
            if stats is None:
                continue                    # no data yet: not a breach
            checks = (
                ("p95_s", stats["p95_s"], rule.max_p95_seconds, 1),
                ("windows_per_s", stats["windows_per_s"],
                 rule.min_windows_per_s, -1),
                ("mbps", stats["mbps"], rule.min_mbps, -1),
                ("queue_rows", stats["queue_rows"],
                 rule.max_queue_rows, 1),
                ("mac_failure_rate", stats["mac_failure_rate"],
                 rule.max_mac_failure_rate, 1),
            )
            for metric, value, limit, sign in checks:
                if limit is None or value is None:
                    continue
                if (sign > 0 and value > limit) or \
                        (sign < 0 and value < limit):
                    return ("slo_breach", st, metric, value, limit)
        return None

    def check(self, now: Optional[float] = None) -> List[Breach]:
        """Evaluate every rule; fire callbacks + audit events for rules
        newly entering the breached state; re-arm recovered rules."""
        now = self._clock() if now is None else now
        fired: List[Breach] = []
        for rule in self.rules:
            viol = self._violation(rule, now)
            was = self._latched.get(rule.name, False)
            if viol is not None and not was:
                kind, stage, metric, value, limit = viol
                self._latched[rule.name] = True
                b = Breach(rule=rule.name, kind=kind, stage=stage,
                           metric=metric,
                           value=None if value is None else float(value),
                           limit=float(limit), t=now)
                self.audit.record(kind, rule=b.rule, stage=b.stage,
                                  metric=b.metric, value=b.value,
                                  limit=b.limit)
                self.fired.append(b)
                fired.append(b)
                for cb in self.on_breach:
                    cb(b)
            elif viol is None and was:
                self._latched[rule.name] = False
        return fired
