"""The plain reference against the port on tiny granite-shaped (multi-query,
GELU) and musicgen-shaped (audio frames, GELU) models on the CPU, in
float32 so that the two agree to rounding."""
import copy

import pytest
import torch

from portbench.lib import spec
from portbench.lib.port import model_config
from portbench.lib.train import change_norms
from portbench.reference import dense

BENCH = spec.benchmark()


def tiny(name):
    cfg = copy.deepcopy(spec.load_config(BENCH, name))
    m = spec.model(cfg)
    m.update(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=128,
             vocab_size=256, num_kv_heads=min(m["num_kv_heads"], 4))
    if m["frontend"] != "none":
        m["frontend_dim"] = 8
    return m, cfg


def f32(tree):
    return {k: f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["granite-34b", "musicgen-selfattn-2.4b"])
def test_last_logits_match_the_port(name):
    from repro_torch.models import api
    m, _ = tiny(name)
    w = f32(spec.make_weights(m, 3, "cpu"))
    batch = spec.train_batch(m, 3, 0, 2, 24, "cpu")
    batch["frames"] = batch.get("frames", torch.zeros(0)).float()
    if m["frontend"] == "none":
        del batch["frames"]
    want, _ = api.prefill(model_config(name, m), w, {
        k: v for k, v in batch.items() if k != "labels"})
    got = dense.last_logits(m, w, batch["tokens"], batch.get("frames"))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fp8_control_departs_from_the_reference():
    m, _ = tiny("granite-34b")
    w = spec.make_weights(m, 4, "cpu")
    toks = spec.prompts(m, 4, 0, 2, 32, "cpu")
    exact = dense.last_logits(m, w, toks)
    low = dense.last_logits(m, w, toks, fp8=True)
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 0.02 < rel < 0.5


@pytest.mark.parametrize("name", ["musicgen-selfattn-2.4b", "granite-34b"])
def test_adamw_steps_match_the_port(name):
    from repro_torch.configs.base import OptimizerConfig, RunConfig, \
        ShapeConfig
    from repro_torch.train.steps import make_train_step
    from portbench.lib.train import OPTIMIZER_KEYS
    m, cfg = tiny(name)
    opt = copy.deepcopy(spec.load_config(BENCH, "musicgen-selfattn-2.4b")
                        ["optimizer"])
    B, S = 2, 16
    w = f32(spec.make_weights(m, 5, "cpu"))
    batches = []
    for n in range(3):
        b = spec.train_batch(m, 5, n, B, S, "cpu")
        if "frames" in b:
            b["frames"] = b["frames"].float()
        batches.append(b)
    run = RunConfig(model=model_config(name, m),
                    shape=ShapeConfig("t", S, B, "train"),
                    optimizer=OptimizerConfig(**{k: opt[k] for k in
                                                 OPTIMIZER_KEYS}),
                    remat="full")
    step_fn, optimizer = make_train_step(run)
    params, state, losses = w, optimizer.init(w), []
    for n, b in enumerate(batches):
        params, state, metrics = step_fn(params, state, b, n)
        losses.append(float(metrics["loss"]))
        if n == 0:
            first = {k: t / (1 - opt["beta1"])
                     for k, t in spec.leaves(state["m"])}
    changes = change_norms(params, w)
    dist = {}
    ref = dense.train(m, opt, w, batches, first_grad=lambda k, g:
                      dist.__setitem__(k, float((first[k] - g).norm())))
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for k in ref["grad_norms"]:
        assert float(first[k].norm()) == pytest.approx(ref["grad_norms"][k],
                                                      rel=1e-3)
        assert dist[k] <= 1e-3 * ref["grad_norms"][k]
        assert changes[k] == pytest.approx(ref["change_norms"][k], rel=1e-3,
                                           abs=1e-7)
