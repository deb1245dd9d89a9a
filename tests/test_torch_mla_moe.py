"""Moonlight-16B-A3B's block in the port (latent attention, a dense first
layer, the sigmoid-routed dropless MoE with a shared expert) against the
benchmark's plain reference of it, ``portbench/reference/mla_moe.py``,
at ``reduce_for_smoke`` size on the CPU, on weights drawn as the harness
draws them (a non-zero correction bias).

The port runs here on the weights upcast to f32, so it computes the
reference's function in another order: within 2e-5 relative.  (In bf16
a token whose (k)th and (k+1)th choice lie close picks another expert
than the f32 reference, and a tiny model's logits then move by far more
than rounding: the benchmark's comparison, at the published widths,
deals with that.)  Also: kernel 7's CPU path at Dqk != Dv, the
published counts, the spans and the counter, and training refused.
"""
import dataclasses
import math

import pytest
import torch

from portbench.lib import port, spec
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.configs.base import MLAConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import api, moe as MOE
from repro_torch.obs import REGISTRY, Tracer
from repro_torch.obs import trace
from _torch_threads import one_torch_thread  # noqa: F401

FULL = get_model_config("moonlight-16b-a3b")
CFG = reduce_for_smoke(FULL)
FAMILY = spec.load("reference", "mla_moe")
#: the port in f32 against the f32 reference: the same function summed in
#: another order
F32_RTOL = 2e-5


def _sizes(cfg=CFG) -> spec.Model:
    """The harness's ``model`` group of ``cfg``, its sub-configs nested."""
    d = dataclasses.asdict(cfg)
    d.pop("arch_id")
    return spec.Model(d, "mla_moe")


def _f32(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float()
    return {k: _f32(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    return spec.make_weights(_sizes(), 2**31 + 77, "cpu")


def _tokens(B, S, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, (B, S), generator=g,
                         dtype=torch.int32)


def _rel(got, want):
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def test_smoke_config_carries_the_new_fields():
    assert (CFG.num_layers, CFG.first_dense_layers) == (3, 1)
    assert CFG.mla == MLAConfig(32, 16, 8, 16) and CFG.head_dim == 24
    m, sm = CFG.moe, CFG.sigmoid_moe
    assert (m.num_experts, m.top_k, sm.num_shared_experts) == (8, 2, 1)
    assert sm.routed_scale == 2.446
    assert api.param_template(CFG)["layers"]["moe"]["bias"].shape == (
        2, m.num_experts)


def test_harness_layout_is_the_ports(weights):
    port.model_config("moonlight-smoke", _sizes())
    assert weights["layers"]["moe"]["bias"].abs().max() > 0


def test_prefill_logits_equal_the_reference(weights):
    tokens = _tokens(2, 24)
    want = FAMILY.last_logits(_sizes(), weights, tokens)
    got, cache = api.prefill(CFG, _f32(weights), {"tokens": tokens},
                             max_seq=30)
    assert _rel(got, want) <= F32_RTOL
    a = CFG.mla
    assert cache["attn"]["ckv"].shape == (3, 2, 30, a.kv_lora_rank)
    assert cache["attn"]["kpe"].shape == (3, 2, 30, a.qk_rope_head_dim)
    assert not cache["attn"]["ckv"][:, :, 24:].any()


def test_prefill_then_decode_equals_the_full_forward(weights):
    """Prefill 20 tokens, then 4 teacher-forced steps through the latent
    cache (the absorbed form): each step's logits against the reference's
    full forward over the prompt so far."""
    tokens = _tokens(2, 24, seed=5)
    params = _f32(weights)
    _, cache = api.prefill(CFG, params, {"tokens": tokens[:, :20]},
                           max_seq=24)
    for pos in range(20, 24):
        got, cache = api.decode_step(CFG, params, tokens[:, pos:pos + 1],
                                     pos, cache)
        want = FAMILY.last_logits(_sizes(), weights, tokens[:, :pos + 1])
        assert _rel(got, want) <= F32_RTOL, pos


def _recorded_choices(weights, tokens, monkeypatch, route=None):
    """The port's expert ids of each MoE layer in a prefill of ``tokens``
    in f32, its router replaced by ``route`` if given."""
    real, seen = MOE.route_sigmoid, []
    route = route or real

    def recording(*args, **kwargs):
        topw, topi = route(*args, **kwargs)
        seen.append(topi.view(*tokens.shape, -1))
        return topw, topi
    monkeypatch.setattr(MOE, "route_sigmoid", recording)
    api.prefill(CFG, _f32(weights), {"tokens": tokens})
    monkeypatch.setattr(MOE, "route_sigmoid", real)
    return seen


def _bias_dropped(router, bias, xf, top_k, sm):
    return _ROUTE(router, torch.zeros_like(bias), xf, top_k, sm)


def _bottom_k(router, bias, xf, top_k, sm):
    """The router sorting the wrong way: the bottom k of score + bias,
    weighed as the top k would be."""
    scores = torch.sigmoid(xf.float() @ router)
    topi = torch.sort(scores + bias, dim=-1, stable=True).indices[:, :top_k]
    topw = scores.gather(1, topi)
    return topw / topw.sum(-1, keepdim=True) * sm.routed_scale, topi


_ROUTE = MOE.route_sigmoid


def test_the_reference_replays_given_choices(weights, monkeypatch):
    """The reference's ``choices``: the port's own choices (in f32, the
    reference's too) replayed give the reference's logits; other experts
    other logits."""
    tokens = _tokens(2, 16, seed=9)
    seen = _recorded_choices(weights, tokens, monkeypatch)
    assert len(seen) == CFG.num_layers - CFG.first_dense_layers
    want = FAMILY.last_logits(_sizes(), weights, tokens)
    replayed = FAMILY.last_logits(_sizes(), weights, tokens, choices=seen)
    assert _rel(replayed, want) <= 1e-6
    other = [(c + 1) % CFG.moe.num_experts for c in seen]
    assert _rel(FAMILY.last_logits(_sizes(), weights, tokens,
                                   choices=other), want) > 1e-2


@pytest.mark.parametrize("router,least,most", [
    ("sound", 0.0, 0.0), ("bias_dropped", 0.03, 0.3),
    ("bottom_k", 0.9, 1.0)])
def test_the_reference_checks_the_choices_it_replays(
        weights, monkeypatch, router, least, most):
    """As it replays choices the reference counts, a MoE layer at a time,
    those below its own (k)th biased score and those below it by more
    than ``CHOICE_MARGIN``: none of the port's own choices in f32; a
    share of a router's that drops the correction bias; nearly all of one
    that takes the bottom k."""
    tokens = _tokens(2, 32, seed=9)
    route = {"sound": None, "bias_dropped": _bias_dropped,
             "bottom_k": _bottom_k}[router]
    seen = _recorded_choices(weights, tokens, monkeypatch, route)
    misses = []
    FAMILY.last_logits(_sizes(), weights, tokens, choices=seen,
                       misses=misses)
    given = tokens.numel() * CFG.moe.top_k
    assert [n for _, _, n in misses] == [given] * len(seen)
    flips = sum(f for f, _, _ in misses) / (given * len(seen))
    beyond = sum(b for _, b, _ in misses) / (given * len(seen))
    assert least <= beyond <= flips <= most


def _layer_input(weights, T=48):
    g = torch.Generator().manual_seed(11)
    x = torch.randn((1, T, CFG.d_model), generator=g)
    p = {k: v[0].float() if not isinstance(v, dict)
         else {kk: vv[0].float() for kk, vv in v.items()}
         for k, v in weights["layers"]["moe"].items()}
    return x, p


def _reference_moe(p, x):
    w = {k: v for k, v in p.items() if k != "shared"}
    w.update({f"shared.{k}": v for k, v in p["shared"].items()})
    return FAMILY.moe(_sizes(), w, x, fp8=False)


def test_the_bias_chooses_experts_and_only_chooses(weights):
    """The correction bias changes some tokens' experts, and the port's
    layer without it differs from the reference's by far more than the
    tolerance; the weights are the unbiased scores, renormalised and
    scaled."""
    x, p = _layer_input(weights)
    p = dict(p, bias=p["bias"] * 8)            # a bias that matters here
    xf = x.reshape(-1, CFG.d_model)
    w_b, i_b = MOE.route_sigmoid(p["router"], p["bias"], xf, 2, CFG.sigmoid_moe)
    w_0, i_0 = MOE.route_sigmoid(p["router"], torch.zeros_like(p["bias"]),
                                 xf, 2, CFG.sigmoid_moe)
    changed = (i_b != i_0).any(-1)
    assert 0 < changed.sum() < len(changed)
    scores = torch.sigmoid(xf @ p["router"])
    want = scores.gather(1, i_b)
    want = want / want.sum(-1, keepdim=True) * CFG.sigmoid_moe.routed_scale
    assert torch.allclose(w_b, want, rtol=1e-6)
    ref = _reference_moe(p, x)
    assert _rel(MOE.moe_dropless(p, x, CFG), ref) <= F32_RTOL
    unbiased = MOE.moe_dropless(dict(p, bias=torch.zeros_like(p["bias"])),
                                x, CFG)
    assert _rel(unbiased, ref) > 100 * F32_RTOL


def test_a_skewed_router_drops_no_assignment(weights):
    """One expert chosen by every token (T·1 of the T·k assignments, 4x
    the mean load of T·k/X at X = 8, k = 2, past 1.25x): every one is
    computed, as the reference's, and the counter counts T·k."""
    x, p = _layer_input(weights)
    bias = torch.zeros_like(p["bias"])
    bias[3] = 10.0
    p = dict(p, bias=bias)
    T, k, X = x.shape[1], CFG.moe.top_k, CFG.moe.num_experts
    _, topi = MOE.route_sigmoid(p["router"], bias, x.reshape(T, -1), k,
                                CFG.sigmoid_moe)
    load = (topi == 3).sum().item()
    assert load == T and load > 1.25 * T * k / X
    before = REGISTRY.counter("moe.routed_assignments").value
    got = MOE.moe_dropless(p, x, CFG)
    assert REGISTRY.counter("moe.routed_assignments").value - before \
        == T * k
    assert _rel(got, _reference_moe(p, x)) <= F32_RTOL


def test_grouped_product_is_torchs_grouped_mm():
    """The plain grouped product (the CPU's) takes the (G,) int32 ends as
    ``torch._grouped_mm``'s ``offs``, empty groups included."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn((40, 16), generator=g).bfloat16()
    w = torch.randn((4, 16, 24), generator=g).bfloat16()
    ends = torch.tensor([7, 7, 30, 40], dtype=torch.int32)
    got = MOE.grouped_mm(a, w, ends)
    assert torch.equal(got, torch._grouped_mm(a, w, offs=ends))
    assert torch.equal(got[7:30], a[7:30] @ w[2])


@pytest.mark.parametrize("causal", [True, False])
def test_kernel7_cpu_path_takes_v_of_another_width(causal):
    """Kernel 7's wrapper at (Dqk, Dv) = (24, 16): the output has Dv
    columns, the scale is 1/sqrt(Dqk), both layouts agree; on meta
    tensors the operator's output is (..., Dv) and its FLOPs 2·(Dqk + Dv)
    a pair."""
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn((2, 3, 20, 24), generator=g) for _ in range(2))
    v = torch.randn((2, 3, 20, 16), generator=g)
    s = q @ k.transpose(-1, -2) / math.sqrt(24)
    if causal:
        s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1),
                          float("-inf"))
    want = torch.softmax(s, -1) @ v
    got, lse = flash_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                              return_lse=True)
    assert got.shape == (2, 3, 20, 16)
    assert (got - want).abs().max() <= 1e-5
    assert (lse - torch.logsumexp(s, -1)).abs().max() <= 1e-5
    bshd = flash_ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                     causal=causal)
    assert torch.equal(bshd.transpose(1, 2), got)
    from torch.utils.flop_counter import FlopCounterMode
    qm, km, vm = (t.to("meta", torch.bfloat16).transpose(1, 2)
                  for t in (q, k, v))
    with FlopCounterMode(display=False) as fc:
        out = flash_ops.flash_attention(qm, km, vm, causal=causal)
    assert out.shape == (2, 20, 3, 16)
    pairs = flash_ops.attended_pairs(2, 3, 20, 20, causal)
    assert fc.get_total_flops() == 2 * (24 + 16) * pairs \
        == flash_ops.flops(2, 3, 20, 20, 24, causal, 16)
    with pytest.raises(ValueError, match="do not match"):
        flash_ops.flash_attention_bhsd(q, k[..., :16], v)


def test_kernel7_routes_the_latent_pair_to_its_instantiation():
    bf16, f32 = torch.bfloat16, torch.float32
    assert flash_ops.latent_pair(bf16, 192, 128)
    assert not flash_ops.latent_pair(f32, 192, 128)
    assert not flash_ops.latent_pair(bf16, 192, 192)
    assert flash_ops.takes_tma(bf16, 128, 64) and flash_ops.takes_tma(
        bf16, 64, 128) and not flash_ops.takes_tma(bf16, 256, 128)
    q = torch.empty((1, 8, 2, 192), dtype=bf16)
    v = torch.empty((1, 8, 2, 128), dtype=bf16)
    assert flash_ops.padded_width(q, q, v) is None
    assert flash_ops.padded_width(q[..., :190], q[..., :190],
                                  v[..., :118]) == (192, 120)


def test_published_counts():
    """15,960,110,208 parameters (the correction bias and the norms
    counted); the family module's active weight elements a token."""
    assert FULL.param_count() == 15_960_110_208
    m = spec.Model(dataclasses.asdict(FULL), "mla_moe")
    assert sum(math.prod(l[1]) for l in FAMILY.layout(m)) == 15_960_110_208
    w = FAMILY.matmul_weights(m)
    assert (w["layers"], w["lm_head"]) == (2_243_559_424, 335_544_320)
    assert FAMILY.attention_flops(m, 1, 2) == 27 * 640 * 16 * 3
    port.model_config("moonlight-16b-a3b", _sizes(FULL))
    cfg = spec.load_config(spec.benchmark(), "moonlight-16b-a3b")
    assert port.model_config("moonlight-16b-a3b", spec.model(cfg)) == FULL
    assert cfg["reduced"] == []


def test_spans_and_the_counter():
    tracer = Tracer()
    params = api.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    before = REGISTRY.counter("moe.routed_assignments").value
    with trace.active(tracer):
        api.prefill(CFG, params, {"tokens": _tokens(2, 16)})
    names = {s.name for s in tracer.find()}
    assert {"attn.mla_up", "moe.route", "moe.experts", "moe.shared"} <= names
    assert len(tracer.find("attn.mla_up")) == CFG.num_layers
    assert len(tracer.find("moe.route")) == 2
    assert REGISTRY.counter("moe.routed_assignments").value - before \
        == 2 * 2 * 16 * CFG.moe.top_k


def test_training_is_refused():
    params = api.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": _tokens(1, 8), "labels": _tokens(1, 8)}
    with pytest.raises(NotImplementedError, match="does not train"):
        api.loss_fn(CFG, params, batch)
    with pytest.raises(NotImplementedError, match="does not train"):
        api.forward(CFG, params, batch)
