"""Simulated SGX quotes: signed (worker, measurement, report_data) claims.

A real deployment would call the Quoting Enclave and verify via IAS/DCAP;
here the quoting key is a software HMAC secret shared between the QE and
the verifier (standing in for the EPID/ECDSA group key — see the README
"Attestation & trust model" section for exactly what this does and does
not prove).  Everything *around* the signature is real: measurements are
allowlisted, quotes expire against a logical clock, revoked worker ids
are rejected, and ``report_data`` binds a quote to one handshake's DH
public value so a quote cannot be replayed into a different session.
"""
from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass, field
from typing import Optional, Set


class QuoteError(RuntimeError):
    """Quote failed verification; ``reason`` is a stable machine tag."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"quote rejected ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


@dataclass(frozen=True)
class Quote:
    worker_id: str
    measurement: bytes          # repro_torch.attest.measure digest
    report_data: bytes          # caller-bound data (e.g. H(DH pub))
    issued_at: int              # quoting enclave's logical clock
    signature: bytes

    def body(self) -> bytes:
        return b"|".join([b"quote-v1", self.worker_id.encode(),
                          self.measurement, self.report_data,
                          str(self.issued_at).encode()])


class QuotingKey:
    """The (software) quoting enclave's signing secret."""

    def __init__(self, secret: bytes):
        self._secret = secret

    @classmethod
    def from_seed(cls, seed: int) -> "QuotingKey":
        return cls(hashlib.sha256(f"repro-quoting-{seed}".encode()).digest())

    def _sign(self, body: bytes) -> bytes:
        return hmac.new(self._secret, body, hashlib.sha256).digest()

    def quote(self, worker_id: str, measurement: bytes,
              report_data: bytes = b"", *, now: int = 0) -> Quote:
        q = Quote(worker_id=worker_id, measurement=measurement,
                  report_data=report_data, issued_at=now, signature=b"")
        return Quote(worker_id=worker_id, measurement=measurement,
                     report_data=report_data, issued_at=now,
                     signature=self._sign(q.body()))

    def check_signature(self, q: Quote) -> bool:
        return hmac.compare_digest(self._sign(q.body()), q.signature)


@dataclass
class QuotePolicy:
    """What the verifier accepts: allowlisted measurements, a freshness
    window, and a revocation list (the live-eviction mechanism)."""

    allowed_measurements: Set[bytes] = field(default_factory=set)
    max_quote_age: Optional[int] = None   # logical-clock ticks; None = any
    revoked: Set[str] = field(default_factory=set)

    def allow(self, measurement: bytes) -> None:
        self.allowed_measurements.add(measurement)

    def is_revoked(self, worker_id: str) -> bool:
        return worker_id in self.revoked


def verify_quote(qk: QuotingKey, q: Quote, policy: QuotePolicy, *,
                 now: int = 0,
                 expect_report_data: Optional[bytes] = None) -> None:
    """Full verdict; raises :class:`QuoteError` with a stable reason tag.

    Order matters for the error surface: a forged signature is rejected
    before any policy detail leaks.
    """
    if not qk.check_signature(q):
        raise QuoteError("bad-signature", q.worker_id)
    if policy.is_revoked(q.worker_id):
        raise QuoteError("revoked", q.worker_id)
    if q.measurement not in policy.allowed_measurements:
        raise QuoteError("measurement-not-allowed",
                         f"{q.worker_id}: {q.measurement.hex()[:16]}...")
    if policy.max_quote_age is not None and \
            now - q.issued_at > policy.max_quote_age:
        raise QuoteError("stale",
                         f"{q.worker_id}: age {now - q.issued_at} > "
                         f"{policy.max_quote_age}")
    if expect_report_data is not None and \
            not hmac.compare_digest(q.report_data, expect_report_data):
        raise QuoteError("report-data-mismatch", q.worker_id)
