"""The static operator registry of the enclave executor, in plain torch.

Port of ``OPS`` in ``repro/kernels/enclave_map/enclave_map.py``: the
"enclaved bytecode" fixed at attestation time.  Each op maps (rows, 16)
int32-carried words to the same shape:

* ``identity``         — pure re-key (router-to-router transfer)
* ``scale_f32``        — y = x * c
* ``relu_f32``         — y = max(x, 0)
* ``square_f32``       — y = x * x
* ``threshold_mask``   — y = (x > c) ? x : 0   (filter as dense mask)
* ``delay_filter_u32`` — keep a packed flight record iff delay > c

The float ops reproduce the reference's bits exactly, as the JAX CPU
backend computes them: denormal inputs read as
signed zero (DAZ) and a product whose exact value is below 2^-126 in
magnitude is flushed to signed zero before rounding (FTZ), NaN
propagation follows x86 ``mulss`` (the constant's NaN first, then x's,
quieted; an invalid product gives 0xFFC00000), and ``relu_f32`` /
``threshold_mask`` select x's own bits.  These are spelled out on the
bit patterns, not left to the device, so the CUDA kernel
(``repro_torch/csrc/enclave_map.cu``) and this plain version agree on
every input on any device.  The constant is rounded to f32 as JAX
rounds a weak-typed Python scalar (``np.float32(c)``);
``delay_filter_u32`` compares word 1 as a signed int32 against
``int(c)``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

SIGN_BIT = -0x80000000          # 0x80000000 as an int32
EXP_MASK = 0x7F800000
ABS_MASK = 0x7FFFFFFF
QUIET_BIT = 0x00400000
DEFAULT_NAN = -0x00400000       # 0xFFC00000 as an int32
MIN_NORMAL = 2.0 ** -126


def const_bits(c: float) -> int:
    """The f32 bit pattern (as an int32 value) ``c`` rounds to."""
    return int(np.array(c, dtype=np.float32).view(np.int32))


def const_int(c: float) -> int:
    """``delay_filter_u32``'s threshold: ``c`` truncated toward zero."""
    if not math.isfinite(c):
        raise ValueError(f"delay_filter_u32 needs a finite const, got {c}")
    return int(c)


def _isnan(b: torch.Tensor) -> torch.Tensor:
    return (b & ABS_MASK) > EXP_MASK


def _daz(b: torch.Tensor) -> torch.Tensor:
    return torch.where((b & EXP_MASK) == 0, b & SIGN_BIT, b)


def _f32(b: torch.Tensor) -> torch.Tensor:
    return _daz(b).view(torch.float32)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product on bit patterns under DAZ + FTZ (before rounding)."""
    p = _f32(a).double() * _f32(b).double()     # exact: 24+24 bits < 53
    out = p.float().view(torch.int32)
    out = torch.where(p.abs() < MIN_NORMAL,
                      torch.where(torch.signbit(p), SIGN_BIT, 0), out)
    out = torch.where(torch.isnan(p), DEFAULT_NAN, out)
    out = torch.where(_isnan(a), a | QUIET_BIT, out)
    return torch.where(_isnan(b), b | QUIET_BIT, out).to(torch.int32)


def _const(x: torch.Tensor, c: float) -> torch.Tensor:
    # a fill on the device, not a host->device copy (which would sync)
    return torch.full((), const_bits(c), dtype=torch.int32, device=x.device)


def _op_identity(x, c):
    return x


def _op_scale_f32(x, c):
    return _mul(x, _const(x, c).expand_as(x))


def _op_relu_f32(x, c):
    return torch.where(_isnan(x) | (_f32(x) > 0), x, 0)


def _op_square_f32(x, c):
    return _mul(x, x)


def _op_threshold_mask(x, c):
    return torch.where(_f32(x) > _f32(_const(x, c)), x, 0)


def _op_delay_filter_u32(x, c):
    # records are (rows, 16) words with word 1 = delay minutes; keep the
    # record (dense mask) iff delay > c, word 1 read as a signed int32
    return torch.where(x[:, 1:2] > const_int(c), x, 0)


OPS: Dict[str, Callable] = {
    "identity": _op_identity,
    "scale_f32": _op_scale_f32,
    "relu_f32": _op_relu_f32,
    "square_f32": _op_square_f32,
    "threshold_mask": _op_threshold_mask,
    "delay_filter_u32": _op_delay_filter_u32,
}

#: the kernel's template index of each op (``enum Op`` in enclave_map.cu)
OP_IDS: Dict[str, int] = {name: i for i, name in enumerate(OPS)}
