"""repro_torch.attest: attestation & key lifecycle (quotes, handshake, epochs).

The trust bootstrap SecureStreams assumes pre-done (§4): simulated
enclave measurements and quotes (`measure`, `quote`), an attested DH
handshake (`handshake`), the `KeyDirectory` that owns every live session
key (`directory`), and the epoch ratchet + rotation policy (`rotation`).
"""
from repro_torch.attest.directory import (EdgeHandle, KeyDirectory,
                                    KeyDirectoryError, NoSessionError,
                                    RevokedWorkerError, SessionState,
                                    ephemeral_edge_key)
from repro_torch.attest.handshake import HandshakeEnd, HandshakeError
from repro_torch.attest.measure import (IO_ENDPOINT, measure_bytes, measure_fn,
                                  measure_stage)
from repro_torch.attest.quote import (Quote, QuoteError, QuotePolicy, QuotingKey,
                                verify_quote)
from repro_torch.attest.rotation import hkdf_sha256, key_from_bytes, ratchet_key

__all__ = [
    "EdgeHandle", "KeyDirectory", "KeyDirectoryError", "NoSessionError",
    "RevokedWorkerError", "SessionState", "ephemeral_edge_key",
    "HandshakeEnd", "HandshakeError",
    "IO_ENDPOINT", "measure_bytes", "measure_fn", "measure_stage",
    "Quote", "QuoteError", "QuotePolicy", "QuotingKey", "verify_quote",
    "hkdf_sha256", "key_from_bytes", "ratchet_key",
]
