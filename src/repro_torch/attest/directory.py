"""KeyDirectory: the single owner of live session keys, epochs, counters.

Port of ``repro/attest/directory.py``, deterministic per seed exactly as
the reference is (same seed strings, same draw order), so both packages
derive the same quotes, session keys and epoch ratchets.  This is the
trust-bootstrap layer the paper assumes away ("we assume that
attestation and key establishment was previously performed", §4).  The
port's sealed paths (`core.enclave`, `core.pipeline`) obtain their
:class:`repro_torch.crypto.keys.StageKey` from a directory edge.  The
directory:

* enrolls worker identities (id + measurement) and issues/verifies their
  quotes against a :class:`repro_torch.attest.quote.QuotePolicy`;
* establishes per-edge session keys via the attested DH handshake
  (`repro_torch.attest.handshake`) — both endpoints are quote-checked;
* owns the epoch counter: :meth:`advance_epoch` ratchets every live edge
  key (`repro_torch.attest.rotation`) and zeroes its chunk counter, keeping a
  bounded history so in-flight chunks sealed in epoch N still open after
  the flip to N+1;
* revokes workers live: :meth:`revoke` quarantines an id (its quotes stop
  verifying, pools skip it) and tears down any session it terminates;
* owns the trust domain's **security audit log**
  (:class:`repro_torch.obs.audit.AuditLog`): rekeys, revocations, quote
  rejections, and nonce-space exhaustion are recorded in stream order as
  they happen — the engine appends its data-plane events (MAC failures,
  evictions) to the same log, so one ordered stream covers the run end
  to end.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.attest.handshake import HandshakeEnd, HandshakeError
from repro_torch.attest.quote import (Quote, QuoteError, QuotePolicy, QuotingKey,
                                verify_quote)
from repro_torch.attest.rotation import key_from_bytes, ratchet_key
from repro_torch.crypto.keys import (NONCE_COUNTER_MAX, NonceExhaustedError,
                               StageKey)
from repro_torch.obs.audit import AuditLog


class KeyDirectoryError(RuntimeError):
    """Any directory-level failure (enrollment, admission, counters)."""


class NoSessionError(KeyDirectoryError):
    """An edge has no established (or no longer drainable) session."""


class RevokedWorkerError(KeyDirectoryError):
    """A quarantined worker id was used where trust is required."""

    def __init__(self, worker_id: str, detail: str = ""):
        super().__init__(f"worker {worker_id!r} is revoked"
                         + (f": {detail}" if detail else ""))
        self.worker_id = worker_id


@dataclass
class SessionState:
    """One edge's live session: current key + drainable epoch history."""
    edge: str
    left: str                    # worker ids of the two endpoints
    right: str
    transcript: bytes
    epoch: int
    chunks: int = 0              # sealed-chunk counter, reset per epoch
    keys: Dict[int, StageKey] = field(default_factory=dict)  # epoch -> key

    def key_at(self, epoch: int) -> StageKey:
        """This edge's key at ``epoch`` — chunks always open/re-seal
        under their *ingress* epoch (epoch-local counters; a later
        epoch's key would replay its (key, nonce) pairs).  Raises
        :class:`NoSessionError` once history has pruned the epoch."""
        k = self.keys.get(epoch)
        if k is None:
            raise NoSessionError(
                f"edge {self.edge!r} has no key for epoch {epoch} "
                f"(live: {sorted(self.keys)}) — drained past history")
        return k


@dataclass
class EdgeHandle:
    """A capability-style view of one directory edge, passed to sealing
    code instead of a raw StageKey so rotation is picked up live."""
    directory: "KeyDirectory"
    edge: str

    def key(self, epoch: Optional[int] = None) -> StageKey:
        """The edge's live key (or its key at a past, undrained epoch)."""
        return self.directory.edge_key(self.edge, epoch=epoch)

    @property
    def epoch(self) -> int:
        """The edge's current epoch (advances on every rotation)."""
        return self.directory.session(self.edge).epoch

    def next_counter(self) -> int:
        """Allocate the next managed chunk counter (epoch-local)."""
        return self.directory.next_counter(self.edge)

    def next_counters(self, n: int) -> int:
        """Reserve ``n`` contiguous counters, returning the first — a
        consumer sealing n items per round MUST take the whole block
        (see :meth:`KeyDirectory.next_counters`)."""
        return self.directory.next_counters(self.edge, n)

    def reserve_window(self, n: int) -> "Tuple[int, int]":
        """Atomically reserve a contiguous ``n``-counter block AND snapshot
        the epoch it belongs to: ``(base, epoch)`` — counters base..base+n-1
        are valid only under that epoch's key (counters are epoch-local).
        The window-batched engine reserves one block per sealed window,
        mirroring how ``secure_exchange`` reserves its W^2 nonce block, so
        co-consumers of an edge can never land inside the window's block.
        """
        return (self.directory.next_counters(self.edge, n),
                self.directory.session(self.edge).epoch)


class KeyDirectory:
    """Attestation verifier + key-establishment service + key store."""

    def __init__(self, seed: int = 0, policy: Optional[QuotePolicy] = None,
                 *, epoch_history: int = 8,
                 audit: Optional[AuditLog] = None):
        self.seed = seed
        self.policy = policy if policy is not None else QuotePolicy()
        # THE security audit log of this trust domain: lifecycle events
        # are recorded here by the directory itself; the streaming engine
        # appends its data-plane events (mac_failure, eviction) so one
        # in-order stream covers the whole run.
        self.audit = audit if audit is not None else AuditLog()
        self.epoch = 0
        self.epoch_history = max(1, int(epoch_history))
        self.clock = 0                       # logical time for quote ages
        self._qk = QuotingKey.from_seed(seed)
        self._rng = random.Random(f"repro-attest-{seed}")
        self._workers: Dict[str, bytes] = {}       # id -> measurement
        self._sessions: Dict[str, SessionState] = {}
        # Admission interceptor: callable(worker_id) -> rejection reason
        # or None.  Consulted by admit() BEFORE the quote round-trip so a
        # fault injector can make a live enrollment fail
        # through the real admission path — the rejection lands in the
        # audit log as a genuine quote_rejected event.  None in
        # production.
        self.admission_interceptor = None

    # ------------------------------------------------------------ clock

    def tick(self, n: int = 1) -> int:
        """Advance the logical clock quote freshness is judged against."""
        self.clock += n
        return self.clock

    # ------------------------------------------------- worker lifecycle

    def enroll(self, worker_id: str, measurement: bytes, *,
               allow: bool = False) -> None:
        """Register a worker identity.  Enrollment does NOT grant trust:
        admission happens when its quote verifies against the policy
        (``allow=True`` additionally allowlists the measurement — the
        operator's provisioning step)."""
        prev = self._workers.get(worker_id)
        if prev is not None and prev != measurement:
            raise KeyDirectoryError(
                f"worker {worker_id!r} re-enrolled with a different "
                f"measurement — identities are immutable")
        self._workers[worker_id] = measurement
        if allow:
            self.policy.allow(measurement)

    def quote_for(self, worker_id: str, report_data: bytes = b"") -> Quote:
        """The worker's quoting enclave: a fresh signed quote over its
        enrolled measurement, bound to ``report_data``."""
        m = self._workers.get(worker_id)
        if m is None:
            raise KeyDirectoryError(f"unknown worker {worker_id!r}")
        return self._qk.quote(worker_id, m, report_data, now=self.clock)

    def verify(self, q: Quote,
               expect_report_data: Optional[bytes] = None) -> None:
        """Check a quote against the policy (allowlist, freshness,
        revocation, report-data binding); raises on any failure —
        revoked ids surface as :class:`RevokedWorkerError`."""
        try:
            verify_quote(self._qk, q, self.policy, now=self.clock,
                         expect_report_data=expect_report_data)
        except QuoteError as e:
            self.audit.record("quote_rejected", worker=q.worker_id,
                              reason=e.reason)
            if e.reason == "revoked":
                raise RevokedWorkerError(q.worker_id, str(e)) from e
            raise

    def admit(self, worker_id: str) -> Quote:
        """Quote-then-verify gate; raises on rejection, returns the quote.

        If an ``admission_interceptor`` is installed (fault injection),
        it is consulted first: a returned reason string fails the
        handshake through the same audit path as a bad quote."""
        icpt = self.admission_interceptor
        if icpt is not None:
            reason = icpt(worker_id)
            if reason is not None:
                self.audit.record("quote_rejected", worker=worker_id,
                                  reason=reason)
                raise QuoteError(reason, worker_id)
        q = self.quote_for(worker_id)
        self.verify(q)
        return q

    def is_admitted(self, worker_id: str) -> bool:
        """Non-raising :meth:`admit` (pool-membership checks)."""
        try:
            self.admit(worker_id)
            return True
        except (QuoteError, KeyDirectoryError):
            return False

    # ------------------------------------------------------- sessions

    def _end(self, worker_id: str, context: bytes) -> HandshakeEnd:
        return HandshakeEnd(
            quote_fn=lambda rd: self.quote_for(worker_id, rd),
            verify_fn=lambda q, rd: self.verify(q, expect_report_data=rd),
            secret=self._rng.randrange(2, 1 << 255),
            context=context)

    def establish(self, edge: str, left: str, right: str, *,
                  stage_id: Optional[int] = None) -> StageKey:
        """Run the attested handshake between two enrolled workers and
        install the resulting session key for ``edge``.

        Both flights carry quotes; both ends verify before deriving, so a
        revoked or unallowlisted endpoint cannot obtain (or grant) key
        material.  Re-establishing an existing edge replaces its session
        (the re-handshake path after revocation/recovery).
        """
        if left == right:
            raise KeyDirectoryError(
                f"edge {edge!r} needs two distinct endpoints, got {left!r}")
        context = b"|".join([b"ss-edge", edge.encode(),
                             left.encode(), right.encode()])
        a, b = self._end(left, context), self._end(right, context)
        fa, fb = a.flight(), b.flight()
        mat_a, tr_a = a.derive(fa, fb)        # left verifies right's quote
        mat_b, tr_b = b.derive(fb, fa)        # right verifies left's quote
        if mat_a != mat_b or tr_a != tr_b:    # DH agreement is exact
            raise HandshakeError(f"key agreement failed on edge {edge!r}")
        sid = stage_id if stage_id is not None else len(self._sessions)
        key = key_from_bytes(mat_a, sid)
        # born in the current epoch; older epochs predate the session
        st = SessionState(edge=edge, left=left, right=right,
                          transcript=tr_a, epoch=self.epoch,
                          keys={self.epoch: key})
        self._sessions[edge] = st
        self.tick()
        return key

    def has_session(self, edge: str) -> bool:
        """True if ``edge`` has a live established session."""
        return edge in self._sessions

    def session(self, edge: str) -> SessionState:
        """The edge's live :class:`SessionState`; raises
        :class:`NoSessionError` before :meth:`establish` has run."""
        st = self._sessions.get(edge)
        if st is None:
            raise NoSessionError(
                f"no established session for edge {edge!r} — run "
                f"KeyDirectory.establish (attested handshake) first")
        return st

    def edge_key(self, edge: str, *, epoch: Optional[int] = None) -> StageKey:
        """The edge's session key at ``epoch`` (current when None)."""
        st = self.session(edge)
        return st.key_at(st.epoch if epoch is None else epoch)

    def handle(self, edge: str) -> EdgeHandle:
        """Capability view of an established edge — what sealing code
        holds instead of a raw key, so rotation is picked up live."""
        self.session(edge)                    # must exist
        return EdgeHandle(self, edge)

    def next_counter(self, edge: str) -> int:
        """Allocate the next chunk counter for an edge (epoch-local; the
        StageKey nonce guard backstops wraparound)."""
        return self.next_counters(edge, 1)

    def next_counters(self, edge: str, n: int) -> int:
        """Allocate a contiguous block of ``n`` counters and return the
        first.  A consumer that seals n items per round (secure_exchange
        seals W² blocks) MUST reserve all n — allocating one and deriving
        the rest would collide with the edge's other consumers."""
        if n < 1:
            raise KeyDirectoryError(f"counter block size must be >= 1: {n}")
        st = self.session(edge)
        if st.chunks + n - 1 > NONCE_COUNTER_MAX:
            self.audit.record("nonce_exhausted", edge=edge, epoch=st.epoch,
                              chunks=st.chunks, requested=n)
            raise NonceExhaustedError(
                f"edge {edge!r} would exhaust its nonce space at epoch "
                f"{st.epoch}: {st.chunks} counters used, {n} requested "
                f"(max {NONCE_COUNTER_MAX}) — advance_epoch to reset")
        c = st.chunks
        st.chunks += n
        return c

    def edges(self) -> List[str]:
        """Names of every edge with a live session."""
        return list(self._sessions)

    # ------------------------------------------------------- rotation

    def advance_epoch(self) -> int:
        """Ratchet every live session key to the next epoch and zero its
        chunk counter.  Keys older than ``epoch_history`` epochs are
        dropped (forward secrecy: drained traffic stays sealed)."""
        self.epoch += 1
        for st in self._sessions.values():
            st.keys[self.epoch] = ratchet_key(
                st.key_at(st.epoch), epoch=self.epoch,
                transcript=st.transcript)
            st.epoch = self.epoch
            st.chunks = 0
            for e in [e for e in st.keys
                      if e <= self.epoch - self.epoch_history]:
                del st.keys[e]
        self.audit.record("rekey", epoch=self.epoch,
                          edges=len(self._sessions))
        self.tick()
        return self.epoch

    # ------------------------------------------------------ revocation

    def revoke(self, worker_id: str) -> List[str]:
        """Quarantine a worker: its quotes stop verifying (pools must
        skip it) and every session it terminates is torn down.  Returns
        the edges dropped so the caller can re-handshake survivors.

        Unknown ids are rejected: silently "revoking" a typo'd id would
        leave the real worker processing chunks with no error anywhere.
        """
        if worker_id not in self._workers:
            raise KeyDirectoryError(
                f"cannot revoke unknown worker {worker_id!r} — enrolled "
                f"ids look like {sorted(self._workers)[:4]}")
        self.policy.revoked.add(worker_id)
        dropped = [e for e, st in self._sessions.items()
                   if worker_id in (st.left, st.right)]
        for e in dropped:
            del self._sessions[e]
        self.audit.record("revocation", worker=worker_id,
                          edges=list(dropped))
        self.tick()
        return dropped

    def reestablish(self, edge: str, left: str, right: str, *,
                    stage_id: Optional[int] = None) -> StageKey:
        """Recovery-path re-handshake on a surviving endpoint pair (both
        are re-verified; a revoked survivor still fails)."""
        return self.establish(edge, left, right, stage_id=stage_id)


def ephemeral_edge_key(label: str = "edge", *, seed: int = 0,
                       stage_id: int = 0) -> StageKey:
    """A session key from a throwaway directory (tests/benchmarks): two
    endpoints enrolled, allowlisted, and handshaken — the one sanctioned
    shortcut to a StageKey outside a long-lived directory."""
    from repro_torch.attest.measure import IO_ENDPOINT
    d = KeyDirectory(seed=seed)
    d.enroll(f"{label}/a", IO_ENDPOINT, allow=True)
    d.enroll(f"{label}/b", IO_ENDPOINT, allow=True)
    return d.establish(label, f"{label}/a", f"{label}/b", stage_id=stage_id)
