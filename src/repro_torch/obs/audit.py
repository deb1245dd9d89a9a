"""Security audit log: an append-only, in-order stream of security events.

The port's own copy of the reference audit log.  It records the
engine's *security* behaviour — which rows failed their MAC, when every
edge key rotated, which workers were revoked or evicted, which quotes
were rejected, whether a nonce space was ever exhausted — **as it
happens**, with a strictly increasing sequence number, so tests (and
operators) can assert exact counts and exact ordering: k tampered rows
must yield exactly k ``mac_failure`` events, and a revocation lands
between precisely the rekeys that preceded and followed it.

The :class:`repro_torch.attest.directory.KeyDirectory` owns one log per trust
domain and records the key-lifecycle events itself (rekey, revocation,
quote_rejected, nonce_exhausted); the streaming engine appends the
data-plane events (mac_failure with row counter + epoch + stage,
eviction when a revoked worker is first skipped at dispatch).  Events
are plain data — recording is an append, never an I/O call — and the
log is bounded (oldest events drop past ``max_events``; ``dropped``
counts them) so a hostile stream of tampered rows cannot grow memory
without bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: The closed vocabulary of event kinds — ``record`` rejects typos so a
#: misspelled kind cannot silently create an unqueryable event class.
KINDS = (
    "mac_failure",      # a row failed its CW-MAC check and was dropped
    "rekey",            # KeyDirectory.advance_epoch ratcheted every edge
    "revocation",       # a worker id was quarantined (sessions torn down)
    "eviction",         # the engine first skipped a revoked worker
    "quote_rejected",   # a quote failed policy verification
    "nonce_exhausted",  # a counter reservation would wrap the nonce space
    "slo_breach",       # a Watchdog SLO rule crossed its declared limit
    "stall",            # no window progressed for the rule's grace period
    "worker_failed",    # a worker was lost mid-share (crash or stall)
    "share_retried",    # a share was re-dispatched to the same worker
    "share_failover",   # a share moved to a survivor / spare / backup
    "window_replayed",  # retained ingress rows were re-executed
)


@dataclass(frozen=True)
class AuditEvent:
    """One security event: ``seq`` is the in-order position, ``detail``
    the kind-specific payload (row/epoch/stage for mac_failure, the new
    epoch for rekey, worker + dropped edges for revocation, ...)."""
    seq: int
    kind: str
    detail: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:
        d = " ".join(f"{k}={v}" for k, v in self.detail.items())
        return f"#{self.seq} {self.kind}" + (f" {d}" if d else "")


class AuditLog:
    """Append-only in-order event stream, queryable by kind."""

    def __init__(self, max_events: int = 65536):
        self._events: List[AuditEvent] = []
        self._seq = 0
        self.max_events = max(1, int(max_events))
        self.dropped = 0                      # evicted past max_events

    # ------------------------------------------------------------ recording

    def record(self, kind: str, **detail) -> AuditEvent:
        if kind not in KINDS:
            raise ValueError(f"unknown audit event kind {kind!r}; "
                             f"expected one of {KINDS}")
        ev = AuditEvent(seq=self._seq, kind=kind, detail=detail)
        self._seq += 1
        self._events.append(ev)
        if len(self._events) > self.max_events:
            del self._events[0]
            self.dropped += 1
        return ev

    # -------------------------------------------------------------- queries

    def events(self, kind: Optional[str] = None) -> List[AuditEvent]:
        """All retained events in stream order, optionally one kind."""
        if kind is None:
            return list(self._events)
        if kind not in KINDS:
            raise ValueError(f"unknown audit event kind {kind!r}; "
                             f"expected one of {KINDS}")
        return [e for e in self._events if e.kind == kind]

    def counts(self) -> Dict[str, int]:
        """Retained events per kind (absent kinds included as 0)."""
        out = {k: 0 for k in KINDS}
        for e in self._events:
            out[e.kind] += 1
        return out

    def kind_sequence(self, *kinds: str) -> List[str]:
        """The in-order subsequence of event kinds restricted to
        ``kinds`` (all kinds when empty) — the ordering assertion
        primitive: ``log.kind_sequence("rekey", "revocation")``."""
        keep = set(kinds) if kinds else set(KINDS)
        return [e.kind for e in self._events if e.kind in keep]

    def summary(self) -> Dict[str, Any]:
        """Compact dict for ``Pipeline.report()``: total + per-kind
        counts (zero kinds omitted) + how many events were dropped."""
        counts = {k: n for k, n in self.counts().items() if n}
        return {"events": len(self._events), "dropped": self.dropped,
                **counts}

    def dump(self) -> List[Dict[str, Any]]:
        """Events as plain dicts (JSON-ready)."""
        return [{"seq": e.seq, "kind": e.kind, **e.detail}
                for e in self._events]

    def clear(self) -> None:
        """Drop every retained event and the drop count; ``seq`` keeps
        counting (a cleared log is still the same stream, so ordering
        assertions across a clear stay meaningful)."""
        self._events.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self):
        return iter(self._events)
