"""Mamba2 (SSD) block on the shared chunked-GLA engine (port of
``repro/models/mamba2.py``).

The SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T`` with scalar
per-head ``A`` maps onto :func:`repro_torch.models.gla.chunked_gla` with
``q=C, k=B, v=x, log_f = -exp(A_log)·dt, i = dt``.  Plain torch, as the
reference's jnp.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.gla import chunked_gla, gla_decode_step
from repro_torch.models.layers import ParamSpec, Params, rms_norm


def _dims(cfg) -> Tuple[int, int, int, int]:
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    nheads = d_inner // ssm.headdim
    return d_inner, nheads, ssm.state_dim, ssm.conv_width


def mamba2_template(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, nheads, N, W = _dims(cfg)
    return {
        "in_proj_z": ParamSpec((d, d_inner), ("embed", "mlp")),
        "in_proj_x": ParamSpec((d, d_inner), ("embed", "mlp")),
        "in_proj_B": ParamSpec((d, N), ("embed", None)),
        "in_proj_C": ParamSpec((d, N), ("embed", None)),
        "in_proj_dt": ParamSpec((d, nheads), ("embed", "heads")),
        "conv_x": ParamSpec((W, d_inner), (None, "mlp"), init="normal", scale=0.5),
        "conv_B": ParamSpec((W, N), (None, None), init="normal", scale=0.5),
        "conv_C": ParamSpec((W, N), (None, None), init="normal", scale=0.5),
        "A_log": ParamSpec((nheads,), ("heads",), init="zeros", dtype="float32"),
        "D": ParamSpec((nheads,), ("heads",), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((nheads,), ("heads",), init="zeros", dtype="float32"),
        "norm_inner": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as a sum of shifts, f32, then SiLU.
    x: (B,S,C), w: (W,C)."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(W):
        out = out + pad[:, j:j + S].float() * w[j].float()
    return F.silu(out).to(x.dtype)


def _conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor):
    """state: (B, W-1, C) previous inputs; xt: (B, C). -> (out, state)."""
    window = torch.cat([state, xt[:, None]], dim=1)           # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return F.silu(out).to(xt.dtype), window[:, 1:]


def _gates(p: Params, dt_pre: torch.Tensor):
    """dt_pre: (..., H) -> (log_f, i) both (..., H) f32."""
    dt = F.softplus(dt_pre.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                 # (H,) < 0
    return dt * A, dt


def _mamba2_core(p: Params, x: torch.Tensor, cfg, *, chunk: int = 0,
                 with_state: bool = False):
    B, S, _ = x.shape
    d_inner, nheads, N, W = _dims(cfg)
    hd = cfg.ssm.headdim
    chunk = chunk or cfg.ssm.chunk_size

    z = x @ p["in_proj_z"]
    pre_x = x @ p["in_proj_x"]
    pre_B = x @ p["in_proj_B"]
    pre_C = x @ p["in_proj_C"]
    xs = _causal_conv(pre_x, p["conv_x"])
    Bm = _causal_conv(pre_B, p["conv_B"])
    Cm = _causal_conv(pre_C, p["conv_C"])
    log_f, i_gate = _gates(p, x @ p["in_proj_dt"])

    v = xs.reshape(B, S, nheads, hd)
    q = Cm[:, :, None, :].expand(B, S, nheads, N)
    k = Bm[:, :, None, :].expand(B, S, nheads, N)
    res = chunked_gla(q, k, v, log_f, i_gate, chunk=min(chunk, S),
                      return_state=with_state)
    y, state = res if with_state else (res, None)
    y = y + p["D"][None, None, :, None] * v.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_inner"],
                 cfg.rms_eps)
    out = y @ p["out_proj"]
    if not with_state:
        return out
    cache = {
        "conv_x": pre_x[:, S - (W - 1):],
        "conv_B": pre_B[:, S - (W - 1):],
        "conv_C": pre_C[:, S - (W - 1):],
        "ssm": state[0],
        "ssm_n": state[1],
    }
    return out, cache


def mamba2_forward(p: Params, x: torch.Tensor, cfg, *, chunk: int = 0
                   ) -> torch.Tensor:
    """x: (B, S, E) -> (B, S, E)."""
    return _mamba2_core(p, x, cfg, chunk=chunk, with_state=False)


def mamba2_forward_with_state(p: Params, x: torch.Tensor, cfg, *,
                              chunk: int = 0):
    """Prefill variant: also returns the decode cache (the last W-1
    pre-conv inputs and the f32 SSM state)."""
    return _mamba2_core(p, x, cfg, chunk=chunk, with_state=True)


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1)/token)
# ---------------------------------------------------------------------------


def mamba2_cache_template(cfg, batch: int, dtype: str = "bfloat16"
                          ) -> Dict[str, ParamSpec]:
    d_inner, nheads, N, W = _dims(cfg)
    return {
        "conv_x": ParamSpec((batch, W - 1, d_inner), ("batch", None, "mlp"),
                            init="zeros", dtype=dtype),
        "conv_B": ParamSpec((batch, W - 1, N), ("batch", None, None),
                            init="zeros", dtype=dtype),
        "conv_C": ParamSpec((batch, W - 1, N), ("batch", None, None),
                            init="zeros", dtype=dtype),
        "ssm": ParamSpec((batch, nheads, N, cfg.ssm.headdim),
                         ("batch", "heads", None, None), init="zeros",
                         dtype="float32"),
        "ssm_n": ParamSpec((batch, nheads, N), ("batch", "heads", None),
                           init="zeros", dtype="float32"),
    }


def mamba2_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  cfg):
    """x: (B, 1, E). -> (y (B, 1, E), new cache)."""
    B = x.shape[0]
    d_inner, nheads, N, W = _dims(cfg)
    hd = cfg.ssm.headdim
    xt = x[:, 0]

    z = xt @ p["in_proj_z"]
    xc, conv_x = _conv_step(cache["conv_x"], xt @ p["in_proj_x"],
                            p["conv_x"])
    Bc, conv_B = _conv_step(cache["conv_B"], xt @ p["in_proj_B"],
                            p["conv_B"])
    Cc, conv_C = _conv_step(cache["conv_C"], xt @ p["in_proj_C"],
                            p["conv_C"])
    log_f, i_gate = _gates(p, xt @ p["in_proj_dt"])

    v = xc.reshape(B, nheads, hd)
    q = Cc[:, None, :].expand(B, nheads, N)
    k = Bc[:, None, :].expand(B, nheads, N)
    y, (S_new, n_new) = gla_decode_step(q, k, v, log_f, i_gate,
                                        (cache["ssm"], cache["ssm_n"]))
    y = y + p["D"][None, :, None] * v.float()
    y = y.reshape(B, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_inner"],
                 cfg.rms_eps)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "ssm": S_new, "ssm_n": n_new}
