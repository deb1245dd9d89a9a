"""xLSTM blocks (port of ``repro/models/xlstm.py``): mLSTM (matrix memory,
chunkwise-parallel via GLA) and sLSTM (scalar memory with recurrent gate
connections, inherently sequential).

* mLSTM: the stabilised exponential input gate replaced by a sigmoid, as
  the reference; the normaliser ``n`` is kept, so outputs stay bounded.
* sLSTM keeps the true stabilised exponential gating and the recurrent
  (h_{t-1} -> gates) connections: a Python loop over time with f32
  ``c``, ``n``, ``h`` and ``m`` (the reference's ``lax.scan``).  It is
  sequential by construction, as the xLSTM paper states.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.gla import chunked_gla, gla_decode_step
from repro_torch.models.layers import ParamSpec, Params, rms_norm
from repro_torch.models.loop import scan


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg) -> Tuple[int, int, int]:
    dp = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    H = cfg.num_heads
    return dp, H, dp // H


def mlstm_template(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    dp, H, dh = _mlstm_dims(cfg)
    return {
        "up_x": ParamSpec((d, dp), ("embed", "mlp")),
        "up_z": ParamSpec((d, dp), ("embed", "mlp")),
        "wq": ParamSpec((dp, dp), ("mlp", "heads")),
        "wk": ParamSpec((dp, dp), ("mlp", "heads")),
        "wv": ParamSpec((dp, dp), ("mlp", "heads")),
        "w_i": ParamSpec((dp, H), ("mlp", "heads")),
        "w_f": ParamSpec((dp, H), ("mlp", "heads")),
        "b_f": ParamSpec((H,), ("heads",), init="ones", dtype="float32"),
        "norm_h": ParamSpec((dp,), ("mlp",), init="ones"),
        "down": ParamSpec((dp, d), ("mlp", "embed")),
    }


def _mlstm_qkvgates(p: Params, xin: torch.Tensor, H: int, dh: int):
    lead = xin.shape[:-1]
    # the reference divides by a weakly typed Python float, which jnp
    # rounds to the activations' type first: divide by that rounded value
    scale = torch.full((), dh ** 0.5, dtype=xin.dtype, device=xin.device)
    q = (xin @ p["wq"]).reshape(*lead, H, dh) / scale
    k = (xin @ p["wk"]).reshape(*lead, H, dh)
    v = (xin @ p["wv"]).reshape(*lead, H, dh)
    log_f = F.logsigmoid((xin @ p["w_f"]).float() + p["b_f"])
    i_gate = torch.sigmoid((xin @ p["w_i"]).float())
    return q, k, v, log_f, i_gate


def _mlstm_core(p: Params, x: torch.Tensor, cfg, *, with_state: bool = False):
    B, S, _ = x.shape
    dp, H, dh = _mlstm_dims(cfg)
    xin = x @ p["up_x"]
    z = x @ p["up_z"]
    q, k, v, log_f, i_gate = _mlstm_qkvgates(p, xin, H, dh)
    res = chunked_gla(q, k, v, log_f, i_gate,
                      chunk=min(cfg.xlstm.chunk_size, S), normalize=True,
                      return_state=with_state)
    y, state = res if with_state else (res, None)
    y = y.reshape(B, S, dp).to(x.dtype)
    y = rms_norm(y, p["norm_h"], cfg.rms_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    out = y @ p["down"]
    if with_state:
        return out, {"S": state[0], "n": state[1]}
    return out


def mlstm_forward(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    return _mlstm_core(p, x, cfg, with_state=False)


def mlstm_forward_with_state(p: Params, x: torch.Tensor, cfg):
    return _mlstm_core(p, x, cfg, with_state=True)


def mlstm_cache_template(cfg, batch: int) -> Dict[str, ParamSpec]:
    dp, H, dh = _mlstm_dims(cfg)
    return {
        "S": ParamSpec((batch, H, dh, dh), ("batch", "heads", None, None),
                       init="zeros", dtype="float32"),
        "n": ParamSpec((batch, H, dh), ("batch", "heads", None),
                       init="zeros", dtype="float32"),
    }


def mlstm_decode(p: Params, x: torch.Tensor, cache, cfg):
    B = x.shape[0]
    dp, H, dh = _mlstm_dims(cfg)
    xt = x[:, 0]
    xin = xt @ p["up_x"]
    z = xt @ p["up_z"]
    q, k, v, log_f, i_gate = _mlstm_qkvgates(p, xin, H, dh)
    y, (S_new, n_new) = gla_decode_step(q, k, v, log_f, i_gate,
                                        (cache["S"], cache["n"]),
                                        normalize=True)
    y = y.reshape(B, dp).to(x.dtype)
    y = rms_norm(y, p["norm_h"], cfg.rms_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    return (y @ p["down"])[:, None], {"S": S_new, "n": n_new}


# ---------------------------------------------------------------------------
# sLSTM (sequential; stabilised exponential gating; recurrent gates)
# ---------------------------------------------------------------------------


def slstm_template(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    # 128-aligned GeGLU width, as the reference
    ff = max(128, int(round(d * cfg.xlstm.proj_factor_slstm / 128)) * 128)
    t: Dict[str, ParamSpec] = {}
    for g in ("z", "i", "f", "o"):
        t[f"w_{g}"] = ParamSpec((d, d), ("embed", "heads"))
        # block-diagonal recurrent weights, one (dh, dh) block per head
        t[f"r_{g}"] = ParamSpec((H, dh, dh), ("heads", None, None),
                                init="normal", scale=0.4)
        t[f"b_{g}"] = ParamSpec((d,), ("heads",),
                                init="ones" if g == "f" else "zeros",
                                dtype="float32")
    t["norm_h"] = ParamSpec((d,), ("embed",), init="ones")
    # post-recurrence GeGLU FFN (proj factor 4/3, per the xLSTM paper)
    t["ff_gate"] = ParamSpec((d, ff), ("embed", "mlp"))
    t["ff_up"] = ParamSpec((d, ff), ("embed", "mlp"))
    t["ff_down"] = ParamSpec((ff, d), ("mlp", "embed"))
    return t


def slstm_cache_template(cfg, batch: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model

    def mk(init):
        return ParamSpec((batch, d), ("batch", "embed"), init=init,
                         dtype="float32")
    return {"c": mk("zeros"), "n": mk("zeros"), "h": mk("zeros"),
            "m": mk("zeros")}


def _slstm_step(p: Params, cfg, state, pre, r32):
    """One sLSTM timestep.  state: dict(c, n, h, m) each (B, d) f32; pre:
    the projected inputs w_g x_t (B, d) of each gate; r32: the recurrent
    weights in f32, (H, dh, dh) each."""
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    B = state["h"].shape[0]
    hh = state["h"].reshape(B, H, dh)

    def rec(g):
        r = torch.einsum("bhd,hde->bhe", hh, r32[g])
        return pre[g].float() + r.reshape(B, H * dh) + p[f"b_{g}"]

    z_t = torch.tanh(rec("z"))
    o_t = torch.sigmoid(rec("o"))
    i_pre, f_pre = rec("i"), rec("f")
    log_fgate = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_fgate + state["m"], i_pre)       # stabiliser
    i_t = torch.exp(i_pre - m_new)
    f_t = torch.exp(log_fgate + state["m"] - m_new)
    c_new = f_t * state["c"] + i_t * z_t
    n_new = f_t * state["n"] + i_t
    h_new = o_t * c_new / torch.clamp_min(n_new, 1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _recurrent_f32(p: Params) -> Dict[str, torch.Tensor]:
    return {g: p[f"r_{g}"].float() for g in "zifo"}


def _slstm_ffn(p: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    h = rms_norm(h, p["norm_h"], cfg.rms_eps)
    g = _gelu((h @ p["ff_gate"]).float()).to(h.dtype)
    u = h @ p["ff_up"]
    return (g * u) @ p["ff_down"]


def _slstm_scan(p: Params, cfg, state, pre, r32):
    """The sLSTM over the sequence, one step a token (the reference's
    ``lax.scan``) through the trip-count marker
    (:func:`repro_torch.models.loop.scan`, a plain loop outside an
    analysis).  pre: each gate's projected inputs, (B, S, d), read a step
    at a time.  -> (the final state, [h_t] for each t)."""
    def step(state, pre_t, w):
        return _slstm_step(w, cfg, state, pre_t,
                           {g: w[f"r_{g}"] for g in "zifo"})
    consts = {**{f"b_{g}": p[f"b_{g}"] for g in "zifo"},
              **{f"r_{g}": r32[g] for g in "zifo"}}
    return scan(step, state, pre, consts, keep="h",
                name=f"{__name__}._slstm_scan")


def _slstm_core(p: Params, x: torch.Tensor, cfg, *, with_state: bool = False):
    B, S, d = x.shape
    pre = {g: x @ p[f"w_{g}"] for g in "zifo"}
    state = {k: torch.zeros((B, d), dtype=torch.float32, device=x.device)
             for k in ("c", "n", "h", "m")}
    state, hs = _slstm_scan(p, cfg, state, pre, _recurrent_f32(p))
    h = torch.stack(hs, dim=1).to(x.dtype)                     # (B,S,d)
    out = _slstm_ffn(p, h, cfg)
    if with_state:
        return out, state
    return out


def slstm_forward(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    return _slstm_core(p, x, cfg, with_state=False)


def slstm_forward_with_state(p: Params, x: torch.Tensor, cfg):
    return _slstm_core(p, x, cfg, with_state=True)


def slstm_decode(p: Params, x: torch.Tensor, cache, cfg):
    xt = x[:, 0]
    pre = {g: xt @ p[f"w_{g}"] for g in "zifo"}
    new = _slstm_step(p, cfg, cache, pre, _recurrent_f32(p))
    out = _slstm_ffn(p, new["h"].to(x.dtype), cfg)[:, None]
    return out, new
