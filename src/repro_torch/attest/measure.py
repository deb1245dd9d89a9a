"""Enclave measurements: deterministic identity of the code a worker runs.

SGX's MRENCLAVE is a hash of the enclave's initial memory contents; the
simulated equivalent here is a SHA-256 over the *stage definition* — the
operator name / constant for static-registry ops, or the compiled code
object of a custom fn (bytecode + consts + names, NOT the source file
path, so the same lambda measured in two processes agrees).  A worker is
admitted to key material only if its measurement is on the verifier's
allowlist (repro_torch.attest.quote.QuotePolicy), which is what turns the
paper's "we assume attestation was previously performed" into an actual
check: change one constant in a stage fn and its quote stops verifying.
"""
from __future__ import annotations

import hashlib
import types
from typing import Callable, Optional

MEASUREMENT_LEN = 32


def measure_bytes(*parts: bytes) -> bytes:
    """SHA-256 over length-prefixed parts (order- and boundary-sensitive)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(8, "little"))
        h.update(p)
    return h.digest()


def _measure_code(code: types.CodeType) -> bytes:
    """Canonical hash of a code object, recursing into nested code
    consts — ``repr`` of a nested code object embeds its memory address,
    which would make byte-identical definitions measure differently."""
    const_parts = []
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            const_parts.append(b"code:" + _measure_code(c))
        else:
            const_parts.append(repr(c).encode())
    return measure_bytes(
        b"code",
        code.co_code,
        measure_bytes(*const_parts),
        repr(code.co_names).encode(),
        repr(code.co_varnames[:code.co_argcount]).encode(),
    )


def _value_bytes(v) -> bytes:
    """Canonical bytes of a captured value.  Array-likes hash their full
    contents (dtype + shape + buffer) — ``repr`` elides interior elements
    of large arrays, which would let differently-tampered weights measure
    identically."""
    if hasattr(v, "dtype") and hasattr(v, "shape"):
        import numpy as np
        if hasattr(v, "detach"):             # a torch tensor, any device
            v = v.detach().cpu().numpy()
        a = np.asarray(v)
        return measure_bytes(b"nd", str(a.dtype).encode(),
                             repr(a.shape).encode(), a.tobytes())
    return repr(v).encode()


def measure_fn(fn: Callable) -> bytes:
    """Measurement of a Python callable: code object + captured state.

    Hashes the bytecode + consts (nested code objects measured
    recursively) + names + argcount, AND the function's defaults and
    closure-cell values (full array contents, not reprs) — a stage fn
    whose behavior depends on a captured variable must re-measure when
    that value changes, or a tampered worker would keep verifying.
    Stable across processes for the same definition + captures.
    """
    code = getattr(fn, "__code__", None)
    if code is None:  # builtins / partials: fall back to repr identity
        return measure_bytes(b"callable", repr(fn).encode())
    parts = [b"fn", _measure_code(code)]
    for dflt in getattr(fn, "__defaults__", None) or ():
        parts.append(_value_bytes(dflt))
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            parts.append(_value_bytes(cell.cell_contents))
        except ValueError:          # empty cell (still-unbound name)
            parts.append(b"<empty-cell>")
    return measure_bytes(*parts)


def measure_stage(*, op: str = "custom", const: float = 0.0,
                  fn: Optional[Callable] = None, sgx: bool = True) -> bytes:
    """Measurement of one pipeline stage (repro_torch.core.pipeline.Stage).

    Static-registry stages are measured by (op, const); custom stages by
    the code hash of their fn.  The sgx placement bit is part of the
    identity — moving a stage out of the enclave changes what you attest.
    """
    parts = [b"stage", op.encode(), repr(float(const)).encode(),
             b"sgx" if sgx else b"plain"]
    if fn is not None:
        parts.append(measure_fn(fn))
    return measure_bytes(*parts)


# Trusted I/O endpoints (pipeline ingress/egress, data sources) have no
# operator code; they attest a fixed identity.
IO_ENDPOINT = measure_bytes(b"io-endpoint")
