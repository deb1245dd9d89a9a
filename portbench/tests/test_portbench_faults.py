"""A whole run of each cell's driver, past the harness's look for a card,
on a tiny model on the CPU: sound, it comes out correct; with the timed
path broken underneath, not.  The faults a cell can have on one card: a
step that returns its state unchanged, half of the batch left out (the
mean taken over the rest), a token or an answer altered where it is
produced.  (No cell spans chips, so none leaves out an exchange.)"""
import copy
import time

import pytest
import torch

from portbench.lib import runner, spec

BENCH = spec.benchmark()
PREFILL = "granite-34b.sealed-prefill"
TRAIN = "musicgen-selfattn-2.4b.sealed-train"


def tiny(cell):
    entry = spec.cell_entry(BENCH, cell)
    cfg = copy.deepcopy(spec.load_config(BENCH, entry["config"]))
    cfg["model"].update(num_layers=2, d_model=64, num_heads=4, head_dim=16,
                        d_ff=128, vocab_size=256,
                        num_kv_heads=min(cfg["model"]["num_kv_heads"], 4))
    if cfg["model"]["frontend"] != "none":
        cfg["model"]["frontend_dim"] = 8
    tr = copy.deepcopy(spec.load_traffic(cell))
    if tr["kind"] == "prefill":
        tr["traffic"].update(tokens_per_batch=64, seq_lens=[16, 32, 64],
                             seq_counts=[2, 1, 1])
    else:
        tr["traffic"].update(batch=2, seq_len=16)
    return cfg, tr


def run(cell, seed=2**31 + 11):
    cfg, tr = tiny(cell)
    return runner.run_cell(BENCH, cell, seed=seed, seconds=0.3, trace=False,
                           device="cpu", t_start=time.perf_counter(),
                           config=cfg, traffic=tr)


@pytest.mark.parametrize("cell", [PREFILL, TRAIN])
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.models import api
    real = api.prefill

    def altered(*a, **kw):
        logits, cache = real(*a, **kw)
        logits = logits.clone()
        best = logits.argmax(dim=-1)
        logits[torch.arange(len(best)), best] -= 100.0   # another token wins
        return logits, cache
    monkeypatch.setattr(api, "prefill", altered)
    res = run(PREFILL)
    assert not res["correct"]
    assert res["checks"]["logits_rel_l2"]["value"] > \
        res["checks"]["logits_rel_l2"]["limit"]


@pytest.mark.parametrize("cell", [PREFILL, TRAIN])
def test_a_token_altered_where_it_is_opened(cell, monkeypatch):
    from repro_torch.core import enclave
    from repro_torch.serve import secure
    real = enclave.egress

    def altered(mode, key, chunk):
        x, ok = real(mode, key, chunk)
        if x.dtype == torch.int32:
            x = x.clone()
            x.view(-1)[0] += 1
        return x, ok
    monkeypatch.setattr(enclave, "egress", altered)
    monkeypatch.setattr(secure, "egress", altered)
    res = run(cell)
    assert not res["correct"]
    assert res["checks"]["roundtrip_mismatches"]["value"] > 0


def _patch_step(monkeypatch, wrap):
    from repro_torch.train import steps
    real = steps.make_train_step

    def make(run, **kw):
        step_fn, opt = real(run, **kw)
        return wrap(step_fn), opt
    monkeypatch.setattr(steps, "make_train_step", make)


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    def wrap(step_fn):
        def step(params, state, batch, n):
            _, _, metrics = step_fn(params, state, batch, n)
            return params, state, metrics
        return step
    _patch_step(monkeypatch, wrap)
    res = run(TRAIN)
    assert not res["correct"]
    assert res["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    def wrap(step_fn):
        def step(params, state, batch, n):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return step_fn(params, state, half, n)
        return step
    _patch_step(monkeypatch, wrap)
    res = run(TRAIN)
    assert not res["correct"]
    nums = res["checks"]
    assert nums["loss_gap"]["value"] > nums["loss_gap"]["limit"]


def test_run_refuses_a_host_without_a_card(capsys):
    from portbench import run as entry
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for one without")
    assert entry.main(["--workload", PREFILL, "--seed", "1", "--seconds",
                       "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
