"""Authenticated key establishment: quote-checked DH, transcript-bound.

The shape is the SGX remote-attestation handshake (SP 800-56A-style
unified model, as SecureCloud's key-provisioning service runs it): each
side generates an ephemeral DH share, obtains a quote whose
``report_data`` is a hash binding that share to the session context, and
verifies the peer's quote *before* deriving anything.  The session key is
HKDF(DH shared secret, salt=transcript), where the transcript hashes the
context, both public shares, and both quote signatures — so a
man-in-the-middle who substitutes a share invalidates the quote binding,
and a quote replayed from another session fails the report_data check.

The group is RFC 3526 MODP-2048 over Python ints (an X25519-style
ephemeral-ephemeral exchange built from hashlib/bigint primitives only,
with no curve library dependency; the handshake is a control-plane cost,
not a data-plane one).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Tuple

from repro_torch.attest.quote import Quote
from repro_torch.attest.rotation import hkdf_sha256

# RFC 3526 group 14 (2048-bit MODP); generator 2.
DH_PRIME = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16)
DH_GENERATOR = 2
_PUB_BYTES = 256


class HandshakeError(RuntimeError):
    pass


@dataclass(frozen=True)
class HandshakeMessage:
    """One side's flight: ephemeral DH public share + binding quote."""
    pub: int
    quote: Quote


def bind_share(context: bytes, pub: int) -> bytes:
    """report_data binding a DH share to this session's context."""
    return hashlib.sha256(b"ss-hs-bind|" + context +
                          pub.to_bytes(_PUB_BYTES, "big")).digest()


def _transcript(context: bytes, a: HandshakeMessage,
                b: HandshakeMessage) -> bytes:
    """Order-canonical transcript hash (both ends compute it identically
    without role bookkeeping): context, then flights sorted by share."""
    lo, hi = sorted((a, b), key=lambda m: m.pub)
    h = hashlib.sha256()
    h.update(b"ss-hs-transcript|" + context)
    for m in (lo, hi):
        h.update(m.pub.to_bytes(_PUB_BYTES, "big"))
        h.update(m.quote.signature)
    return h.digest()


class HandshakeEnd:
    """One endpoint of the handshake.

    ``quote_fn(report_data) -> Quote`` asks this worker's quoting enclave
    for a fresh quote over the given binding; ``verify_fn(quote,
    expect_report_data)`` applies the verifier policy to the peer's quote
    and must raise on rejection (repro_torch.attest.quote.verify_quote via the
    KeyDirectory).  ``secret`` is the ephemeral DH exponent (the caller's
    RNG decides determinism).
    """

    def __init__(self, *, quote_fn: Callable[[bytes], Quote],
                 verify_fn: Callable[[Quote, bytes], None],
                 secret: int, context: bytes = b""):
        if not 1 < secret < DH_PRIME - 1:
            raise HandshakeError("ephemeral secret out of range")
        self._quote_fn = quote_fn
        self._verify_fn = verify_fn
        self._x = secret
        self.context = context
        self.pub = pow(DH_GENERATOR, secret, DH_PRIME)

    def flight(self) -> HandshakeMessage:
        return HandshakeMessage(
            pub=self.pub,
            quote=self._quote_fn(bind_share(self.context, self.pub)))

    def derive(self, mine: HandshakeMessage,
               peer: HandshakeMessage) -> Tuple[bytes, bytes]:
        """Verify the peer and derive -> (key material 32B, transcript).

        Raises :class:`HandshakeError` / the verify_fn's QuoteError on a
        substituted share, a replayed quote, or a policy rejection —
        nothing is derived from an unverified peer.
        """
        if not 1 < peer.pub < DH_PRIME - 1:
            raise HandshakeError("peer share out of range")
        if peer.pub == self.pub:
            raise HandshakeError("reflected share")
        self._verify_fn(peer.quote, bind_share(self.context, peer.pub))
        shared = pow(peer.pub, self._x, DH_PRIME)
        transcript = _transcript(self.context, mine, peer)
        key = hkdf_sha256(shared.to_bytes(_PUB_BYTES, "big"),
                          salt=transcript, info=b"ss-session-key")
        return key, transcript
