"""The secure front of LM serving: the flow of the reference's
``examples/secure_serve.py`` on the port.

A client attests the serving enclave (its measurement is allowlisted in
a :class:`~repro_torch.attest.directory.KeyDirectory`), establishes a
session key through the quote-checked handshake, and seals its prompts
(``ingress("encrypted", ...)``: ChaCha20 + CW-MAC, kernels
``ss_chacha20_cipher_pass`` and ``ss_cwmac_mac_tags`` on the card, one
launch each a seal or open);
the server opens them (``egress``) and refuses the batch unless the MAC
verifies.  Prefill and greedy decode then run on the opened tokens
(:mod:`repro_torch.serve.engine`).

The seal and the open are a tracer's spans ``serve.seal`` and
``serve.open``; the port's ``REGISTRY`` counts the prompt tokens of
every opened batch (``serve.prompt_tokens``) and the batches refused
(``serve.mac_refusals``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.attest.directory import KeyDirectory
from repro_torch.attest.measure import IO_ENDPOINT, measure_bytes
from repro_torch.core.enclave import SealedChunk, egress, ingress
from repro_torch.crypto.keys import StageKey
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.trace import NULL_TRACER

EDGE = "client-requests"

_PROMPT_TOKENS = _METRICS.counter("serve.prompt_tokens")
_MAC_REFUSALS = _METRICS.counter("serve.mac_refusals")


class RequestMacError(RuntimeError):
    """A sealed request batch failed its MAC check."""


def attested_session(arch_id: str, *, seed: int = 7
                     ) -> Tuple[KeyDirectory, StageKey, bytes]:
    """Enroll the serving enclave (measured over ``arch_id``) and the
    client endpoint, and establish the request edge: -> (directory, the
    edge's session key, the server's measurement)."""
    directory = KeyDirectory(seed=seed)
    server_m = measure_bytes(b"serve-enclave", arch_id.encode())
    directory.enroll("server", server_m, allow=True)
    directory.enroll("client", IO_ENDPOINT, allow=True)
    key = directory.establish(EDGE, "client", "server", stage_id=0)
    return directory, key, server_m


def seal_prompts(key, prompts: torch.Tensor, counter: int = 0, *,
                 tracer=NULL_TRACER) -> SealedChunk:
    """The client side: (B, S) int32 prompt tokens -> one sealed chunk."""
    with tracer.span("serve.seal"):
        return ingress("encrypted", key, counter, prompts)


def open_prompts(key, sealed: SealedChunk, *, tracer=NULL_TRACER
                 ) -> torch.Tensor:
    """The server side: -> the (B, S) prompt tokens; raises
    :class:`RequestMacError` unless the MAC verifies (one host sync)."""
    with tracer.span("serve.open"):
        prompts, ok = egress("encrypted", key, sealed)
        if not bool(ok):
            _MAC_REFUSALS.inc()
            raise RequestMacError(
                "request MAC failure: sealed prompts refused")
    _PROMPT_TOKENS.inc(prompts.numel())
    return prompts
