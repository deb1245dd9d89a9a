"""Moonlight-16B-A3B's family module (``reference/mla_moe.py``) and the
cell's two MoE metrics: the counts against hand counts at the published
widths, the metric readers on made-up runs, and the configuration file
against the catalog's numbers."""
import functools
import math
from types import SimpleNamespace

import pytest
import torch

from portbench.lib import peaks, runner, spec
from portbench.lib import spans as bench_spans

BENCH = spec.benchmark()
CFG = spec.load_config(BENCH, "moonlight-16b-a3b")
M = spec.model(CFG)
CELL = "moonlight-16b-a3b.sealed-prefill"


def test_the_file_holds_the_published_config():
    """Every key of the source's config.json, as the catalog reads it, at
    the top level; the port's fields match them; nothing cut."""
    assert CFG["reduced"] == [] and CFG["reference"] == "mla_moe"
    pairs = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "num_attention_heads": "num_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "rms_eps",
             "first_k_dense_replace": "first_dense_layers"}
    for src, ours in pairs.items():
        assert CFG[src] == M[ours], src
    a, moe, sm = M["mla"], M["moe"], M["sigmoid_moe"]
    assert (CFG["kv_lora_rank"], CFG["qk_nope_head_dim"],
            CFG["qk_rope_head_dim"], CFG["v_head_dim"]) == (
        a["kv_lora_rank"], a["qk_nope_head_dim"], a["qk_rope_head_dim"],
        a["v_head_dim"])
    assert CFG["q_lora_rank"] is None and CFG["scoring_func"] == "sigmoid"
    assert (CFG["n_routed_experts"], CFG["num_experts_per_tok"],
            CFG["moe_intermediate_size"], CFG["n_shared_experts"],
            CFG["routed_scaling_factor"]) == (
        moe["num_experts"], moe["top_k"], moe["d_expert"],
        sm["num_shared_experts"], sm["routed_scale"])
    # the router the port runs: the bias chooses, the weights renormalised
    assert (CFG["topk_method"], CFG["norm_topk_prob"]) == ("noaux_tc", True)
    assert M["head_dim"] == a["qk_nope_head_dim"] + a["qk_rope_head_dim"]


def test_weights_by_hand():
    d, H, L, V = 2048, 16, 27, 163840
    attn = d * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    moe = d * 64 + 3 * d * 1408 * (2 + 6)
    assert spec.matmul_weights(M) == {
        "layers": L * attn + 3 * d * 11264 + 26 * moe,
        "lm_head": d * V, "frontend": 0}
    assert spec.matmul_weights(M)["layers"] == 2_243_559_424
    total = sum(math.prod(x.shape) for x in spec.layout(M))
    every = attn + 512 + 2 * d
    assert total == 2 * d * V + d + L * every + 3 * d * 11264 \
        + 26 * (d * 64 + 64 + 3 * d * 1408 * (64 + 2))
    assert total == 15_960_110_208


def test_attention_and_experts_by_hand():
    # 640 FLOPs a pair a head: 2·192 for q·k, 2·128 for p·v
    assert spec.attention_flops(M, 2, 4) == 27 * 640 * 2 * 16 * 10
    assert spec.attention_bytes(M, 1, 8, lse=False) \
        == 2 * 8 * 16 * (192 + 192 + 128 + 128)
    fam = spec.family(M)
    T = 32768
    assert fam.routed_expert_flops(M, T) == 26 * T * 6 * 2 * 3 * 2048 * 1408
    assert fam.routed_expert_bytes(M, T) \
        == 26 * 2 * (3 * 64 * 2048 * 1408 + 2 * T * 6 * 2048)
    # a batch of the cell: the experts alone are 60 % of its weight FLOPs
    share = fam.routed_expert_flops(M, T) / (
        2 * spec.matmul_weights(M)["layers"] * T)
    assert 0.59 < share < 0.61


def test_moe_roofline_reads_the_grouped_products():
    read = runner.load_metric("moe_roofline.prefill")
    fam = spec.family(M)
    work = [(16, 2048), (4, 8192)]
    least = sum(peaks.least_seconds(fam.routed_expert_flops(M, B * S),
                                    fam.routed_expert_bytes(M, B * S))
                for B, S in work)
    seen = {}

    def device_s(pattern):
        seen["pattern"] = pattern
        return 4 * least
    r = SimpleNamespace(model=M, trace=SimpleNamespace(device_s=device_s),
                        traced_work=work)
    assert read(r) == pytest.approx(25.0)
    assert seen["pattern"] == read.__globals__["PATTERN"]
    assert read(SimpleNamespace(model=M, trace=None, traced_work=work)) \
        is None
    granite = spec.model(spec.load_config(BENCH, "granite-34b"))
    assert read(SimpleNamespace(model=granite, trace=r.trace,
                                traced_work=work)) is None


def test_idle_moe_reads_the_moe_spans():
    """Idle time under the innermost MoE span of a hand-built trace, a
    traced batch at a time; None without MoE spans (the parent's)."""
    read = runner.load_metric("idle_moe_ms.prefill")
    host = [("serve.prefill", 0, 100), ("moe.route", 10, 20),
            ("moe.experts", 20, 50), ("moe.shared", 50, 60),
            ("moe.route", 70, 80)]
    busy = [(0, 12), (25, 55), (75, 100)]
    trace = SimpleNamespace(host=host, host_busy=busy, host_window=(0, 100))
    got = bench_spans.idle_ns(trace, ("moe.route", "moe.experts",
                                      "moe.shared"))
    assert got == {"moe.experts": 5, "moe.route": 8 + 5, "moe.shared": 5,
                   bench_spans.OUTSIDE: 10}
    r = SimpleNamespace(trace=trace, traced_work=[(1, 1)] * 2)
    assert read(r) == pytest.approx(23 / 1e6 / 2)
    plain = SimpleNamespace(host=host[:1], host_busy=busy,
                            host_window=(0, 100))
    assert read(SimpleNamespace(trace=plain, traced_work=[(1, 1)])) is None
    assert read(SimpleNamespace(trace=None, traced_work=[])) is None


def test_the_cell_reports_the_prefill_metrics_and_its_own():
    ends, layers = runner.cell_metrics(BENCH, CELL, dict.fromkeys(
        ("ttft_p95_ms", "prompt_tokens_per_s", "setup_s")))
    assert {e["name"] for e in ends} == {"ttft_p95_ms",
                                         "prompt_tokens_per_s", "setup_s"}
    assert {e["name"] for e in layers} == {
        "mfu.prefill", "attn_roofline.prefill", "device_idle.prefill",
        "seal_open_ms.prefill", "idle_moe_ms.prefill",
        "moe_roofline.prefill"}
    t = spec.load_traffic(CELL)["traffic"]
    assert [t["tokens_per_batch"] // s for s in t["seq_lens"]] == [16, 8, 4]


def _tiny():
    """The cell at a tiny size (smoke widths, 3 layers, prompts of 16 to
    64 tokens): (configuration, traffic)."""
    cfg = dict(CFG, model=dict(
        M, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=24, d_ff=128, vocab_size=256,
        mla={"kv_lora_rank": 32, "qk_nope_head_dim": 16,
             "qk_rope_head_dim": 8, "v_head_dim": 16},
        moe=dict(M["moe"], num_experts=8, top_k=2, d_expert=32),
        sigmoid_moe=dict(M["sigmoid_moe"], num_shared_experts=1)))
    tr = spec.load_traffic(CELL)
    tr = dict(tr, traffic=dict(tr["traffic"], tokens_per_batch=64,
                               seq_lens=[16, 32, 64]))
    return cfg, tr


def _run(control=None, seed=2**31 + 3):
    import time
    cfg, tr = _tiny()
    return runner.run_cell(BENCH, CELL, seed=seed, seconds=0.3, trace=False,
                           device="cpu", t_start=time.perf_counter(),
                           config=cfg, traffic=tr, control=control)


def test_the_replayed_cell_is_correct_and_its_fp8_control_is_not():
    """With the program's expert choices replayed, the tiny cell's bf16
    logits lie within the cell's limit of the f32 reference; the fp8
    control, under the same choices, far outside it."""
    assert spec.load_traffic(CELL)["kind"] == "prefill_replay"
    res = _run()
    assert res["correct"], res["checks"]
    assert "note unreplayed_batches = 0" in res["lines"]
    fp8 = _run("fp8")
    assert not fp8["correct"]
    assert fp8["checks"]["logits_rel_l2"]["value"] > \
        3 * res["checks"]["logits_rel_l2"]["value"]
    # the control replays the program's choices: its routing reads the
    # program's, and only its logits tell it apart
    assert fp8["checks"]["routing_misses"] == res["checks"]["routing_misses"]
    assert res["checks"]["routing_misses"]["value"] \
        < res["checks"]["routing_misses"]["limit"]


def test_a_replay_that_is_not_the_served_prefill_is_not_correct(
        monkeypatch):
    """Served logits that the second prefill does not give bit for bit
    (the choices recorded would not be the timed path's): the readings
    are infinite."""
    from repro_torch.models import api
    real, calls = api.prefill, []

    def drifting(*a, **kw):
        calls.append(1)
        logits, cache = real(*a, **kw)
        return logits + 1e-3 * len(calls), cache
    monkeypatch.setattr(api, "prefill", drifting)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["logits_rel_l2"]["value"] is None   # not finite


def _bias_dropped(route, router, bias, xf, top_k, sm):
    return route(router, torch.zeros_like(bias), xf, top_k, sm)


def _bottom_k(route, router, bias, xf, top_k, sm):
    """``route_sigmoid`` sorting the wrong way: the bottom k of score +
    bias, weighed as the top k would be."""
    scores = torch.sigmoid(xf.float() @ router)
    topi = torch.sort(scores + bias, dim=-1, stable=True).indices[:, :top_k]
    topw = scores.gather(1, topi)
    return topw / topw.sum(-1, keepdim=True) * sm.routed_scale, topi


@pytest.mark.parametrize("fault", [_bias_dropped, _bottom_k],
                         ids=["bias_dropped", "bottom_k"])
def test_a_router_that_chooses_wrongly_is_not_correct(monkeypatch, fault):
    """A program whose router drops the correction bias, or takes the
    bottom k: the reference replays its choices, so the logits agree, but
    the choices miss the reference's own top-k beyond rounding, past the
    cell's limit."""
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "route_sigmoid",
                        functools.partial(fault, moe.route_sigmoid))
    res = _run()
    assert not res["correct"]
    checks = res["checks"]
    assert checks["logits_rel_l2"]["value"] < checks["logits_rel_l2"]["limit"]
    assert checks["routing_misses"]["value"] \
        > checks["routing_misses"]["limit"]


def test_a_router_the_replay_cannot_record_is_named(monkeypatch):
    """A program that no longer chooses its experts in ``route_sigmoid``
    (a router fused or renamed): the replay records nothing and says
    where it records, rather than failing deep in the reference."""
    from repro_torch.models import moe
    layer, route = moe.moe_dropless, moe.route_sigmoid

    def fused(p, x, cfg):
        recorder = moe.route_sigmoid
        moe.route_sigmoid = route
        try:
            return layer(p, x, cfg)
        finally:
            moe.route_sigmoid = recorder
    monkeypatch.setattr(moe, "moe_dropless", fused)
    with pytest.raises(RuntimeError, match="route_sigmoid"):
        _run()
