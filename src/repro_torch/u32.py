"""The u32 word carrier: ``torch.int32`` tensors holding u32 bit patterns.

PyTorch's ``torch.uint32`` has no add, shift or compare on the CPU, so
the port carries every u32 word as the same 32 bits in an ``int32``
tensor.  Numpy ``uint32`` arrays enter through :func:`from_numpy` (a
``view(np.int32)``, never a value conversion) and leave through
:func:`to_numpy`.  Plain torch arithmetic that needs unsigned semantics
goes through :func:`lift` (int64 in ``[0, 2^32)``) and back through
:func:`narrow`; the CUDA kernels read the same memory as ``uint32_t*``.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
SIGN = 0x80000000


def from_numpy(a, device="cuda") -> torch.Tensor:
    """uint32 (or int32) array -> int32-carried tensor on ``device``
    (always a copy: the tensor never aliases the caller's array)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise ValueError(f"expected uint32 or int32 words, got {a.dtype}")
    return torch.tensor(a, dtype=torch.int32, device=device)


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host array (nonces, keys, row indices) on ``device``
    without a stream sync: a blocking copy from pageable memory would
    wait for every kernel queued before it, so CUDA copies go through
    pinned staging and ``non_blocking``.  The array's dtype is kept; on
    the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def repeat_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """Each row of ``t`` repeated ``n`` times in place (``[a, a, b, b]``)
    as one expand + copy, with no output-size query on the device."""
    return t.unsqueeze(1).expand(t.shape[0], n, *t.shape[1:]) \
        .reshape(-1, *t.shape[1:]).contiguous()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32-carried tensor -> uint32 numpy array (host copy)."""
    if t.dtype != torch.int32:
        raise ValueError(f"expected int32-carried words, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)


def lift(t: torch.Tensor) -> torch.Tensor:
    """int32-carried words -> int64 values in ``[0, 2^32)``."""
    return t.to(torch.int64) & MASK


def narrow(v: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2^32) -> int32-carried words."""
    return (((v & MASK) ^ SIGN) - SIGN).to(torch.int32)
