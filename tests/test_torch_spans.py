"""The port's serving and training spans and counters on the CPU.

A sealed prefill and a training step of ``reduce_for_smoke(granite-34b)``
(2 layers, 4 query heads on 1 KV head, so ``attn.kv_expand`` runs) are
run three ways: with no tracer, with a ``Tracer`` passed to the
factories (active below them), and under ``torch.profiler`` with no
tracer.  The spans must be the same both ways and nest as the layers
do, the results bit for bit the same all three ways; and the
benchmark's idle-by-span partition (``portbench.lib.spans``) must be
exact on hand-built traces.
"""
import re
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.lib import spans as bench_spans
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.obs import NULL_TRACER, REGISTRY, Tracer
from repro_torch.obs import trace
from repro_torch.obs.trace import _NOOP_SPAN
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serve import engine, secure
from repro_torch.train.steps import make_train_step
from _torch_threads import one_torch_thread  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CFG = reduce_for_smoke(get_model_config("granite-34b"))
B, S = 2, 32
SERVE_SPANS = {"serve.seal", "serve.open", "serve.prefill", "attn.kv_expand"}
STEP_SPANS = {"train.fwd", "train.bwd", "attn.bwd", "train.optimizer"}
ALL_SPANS = SERVE_SPANS | STEP_SPANS
#: the spans of latent attention and the dropless MoE, which granite's
#: layers do not run (``tests/test_torch_mla_moe.py`` sees them)
MLA_MOE_SPANS = {"attn.mla_up", "moe.route", "moe.experts", "moe.shared"}
#: the harness's patterns a program span must not match
#: (``portbench/lib/trace.py`` ``is_work``, ``metrics/attn_roofline.*``)
ATTENTION = re.compile(r"flash|fmha|attention", re.IGNORECASE)


def _tokens(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab_size, (B, S), generator=g,
                         dtype=torch.int32)


def _params():
    return api.init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _serve(key, tracer):
    run = RunConfig(model=CFG, shape=ShapeConfig("spans", S, B, "prefill"))
    step = engine.make_prefill_step(run, max_seq=S, tracer=tracer)
    sealed = secure.seal_prompts(key, _tokens(1), 5, tracer=tracer)
    opened = secure.open_prompts(key, sealed, tracer=tracer)
    logits, _ = step(_params(), {"tokens": opened})
    return {"tokens": opened, "logits": logits}


def _train(tracer):
    run = RunConfig(model=CFG, shape=ShapeConfig("spans", S, B, "train"),
                    optimizer=OptimizerConfig(lr=1e-2, warmup_steps=0),
                    remat="full")
    step, opt = make_train_step(run, tracer=tracer)
    params = _params()
    tokens = _tokens(2)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    new, _, metrics = step(params, opt.init(params), batch, 0)
    return {"loss": metrics["loss"], "params": tree_leaves(new)}


def _host_ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in ALL_SPANS]


def _run_three_ways(fn):
    """-> {way: (result, spans)}: a list of (name, start, end) of the
    profiler's ranges, or the Tracer."""
    out = {"bare": (fn(NULL_TRACER), None)}
    tr = Tracer()
    out["tracer"] = (fn(tr), tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn(NULL_TRACER)
    out["profiler"] = (got, _host_ranges(prof))
    return out


@pytest.fixture(scope="module")
def key():
    return secure.attested_session(CFG.arch_id)[1]


@pytest.fixture(scope="module")
def runs(key):
    return {"prefill": _run_three_ways(lambda t: _serve(key, t)),
            "train": _run_three_ways(_train)}


def _count(names):
    return {n: names.count(n) for n in set(names)}


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_profiler_ranges_of_a_sealed_prefill_nest_as_the_layers(runs):
    ranges = runs["prefill"]["profiler"][1]
    assert _count([n for n, _, _ in ranges]) == {
        "serve.seal": 1, "serve.open": 1, "serve.prefill": 1,
        "attn.kv_expand": CFG.num_layers}
    by = {r[0]: r for r in ranges}
    seal, open_, prefill = by["serve.seal"], by["serve.open"], \
        by["serve.prefill"]
    assert seal[2] <= open_[1] and open_[2] <= prefill[1]
    assert all(_within(r, prefill) for r in ranges
               if r[0] == "attn.kv_expand")


def test_profiler_ranges_of_a_train_step_nest_as_the_layers(runs):
    ranges = runs["train"]["profiler"][1]
    L = CFG.num_layers
    # remat "full": each layer's attention runs again in the backward
    assert _count([n for n, _, _ in ranges]) == {
        "train.fwd": 1, "train.bwd": 1, "train.optimizer": 1,
        "attn.bwd": L, "attn.kv_expand": 2 * L}
    by = {r[0]: r for r in ranges}
    fwd, bwd, upd = by["train.fwd"], by["train.bwd"], by["train.optimizer"]
    assert fwd[2] <= bwd[1] and bwd[2] <= upd[1]
    assert all(_within(r, bwd) for r in ranges if r[0] == "attn.bwd")
    expand = sorted(r for r in ranges if r[0] == "attn.kv_expand")
    assert all(_within(r, fwd) for r in expand[:L])
    assert all(_within(r, bwd) for r in expand[L:])


@pytest.mark.parametrize("path", ["prefill", "train"])
def test_a_tracer_records_the_profilers_spans(runs, path):
    tr = runs[path]["tracer"][1]
    assert _count([s.name for s in tr.spans]) == \
        _count([n for n, _, _ in runs[path]["profiler"][1]])
    parent = {s.name: {tr.spans[s.parent].name if s.parent is not None
                       else None for s in tr.find(s.name)}
              for s in tr.spans}
    if path == "train":
        assert parent["attn.bwd"] == {"train.bwd"}
        assert parent["attn.kv_expand"] == {"train.fwd", "train.bwd"}
        assert parent["train.fwd"] == parent["train.optimizer"] == {None}
    else:
        assert parent["attn.kv_expand"] == {"serve.prefill"}
        assert parent["serve.seal"] == parent["serve.open"] == {None}
    assert all(s.end is not None and s.end >= s.start for s in tr.spans)


@pytest.mark.parametrize("path", ["prefill", "train"])
def test_results_are_bit_identical_with_and_without_spans(runs, path):
    bare = runs[path]["bare"][0]
    for way in ("tracer", "profiler"):
        got = runs[path][way][0]
        assert got.keys() == bare.keys()
        for k, want in bare.items():
            have = got[k]
            pairs = zip(have, want) if isinstance(want, list) \
                else [(have, want)]
            for a, b in pairs:
                assert a.dtype == b.dtype and torch.equal(a, b), (way, k)


def test_null_tracer_is_the_shared_noop_outside_a_profiler(runs):
    assert NULL_TRACER.span("train.fwd") is _NOOP_SPAN
    # no factory's call is open: the layers' spans go to NULL_TRACER
    assert trace.span("attn.bwd") is _NOOP_SPAN
    assert NULL_TRACER.span("serve.seal", cat="x", a=1) is _NOOP_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        inside = NULL_TRACER.span("train.fwd")
        assert inside is not _NOOP_SPAN
        with inside:
            pass
    assert NULL_TRACER.span("train.fwd") is _NOOP_SPAN


def test_program_span_names_stay_clear_of_the_harness_patterns(runs):
    seen = {n for path in runs.values()
            for n, _, _ in path["profiler"][1]}
    assert seen == ALL_SPANS
    # every span literal in the serve, train, models and optim packages
    literal = re.compile(r"\.span\(\s*\"([^\"]+)\"")
    written = {m for d in ("serve", "train", "models", "optim")
               for f in (SRC / d).rglob("*.py")
               for m in literal.findall(f.read_text())}
    assert written == ALL_SPANS | MLA_MOE_SPANS
    for name in written:
        assert not ATTENTION.search(name) and not name.startswith(
            "portbench.")


def test_counters_count_tokens_and_refusals(key):
    def value(name):
        return REGISTRY.counter(name).value
    before = {n: value(n) for n in ("serve.prompt_tokens",
                                    "serve.mac_refusals", "train.tokens")}
    _serve(key, NULL_TRACER)
    _train(NULL_TRACER)
    sealed = secure.seal_prompts(key, _tokens(3), 6)
    tag = sealed.tag.clone()
    tag[0] ^= 1
    sealed.tag = tag
    with pytest.raises(secure.RequestMacError):
        secure.open_prompts(key, sealed)
    assert value("serve.prompt_tokens") - before["serve.prompt_tokens"] \
        == B * S
    assert value("train.tokens") - before["train.tokens"] == B * S
    assert value("serve.mac_refusals") - before["serve.mac_refusals"] == 1


def test_tracer_spans_and_export_are_on_the_profilers_clock():
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("serve.seal"):
            time.sleep(0.002)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "serve.seal"]
    (span,) = tr.spans
    assert abs(tr.t0_ns + span.start * 1e9 - ev.start_ns()) < 1e6
    (x,) = [e for e in tr.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert abs(x["ts"] * 1e3 - ev.start_ns()) < 1e6


# ----------------------------------------------------------------------
# the benchmark's idle-by-span partition, on hand-built traces
# ----------------------------------------------------------------------


def _brute(host, busy, window, names):
    """Idle ns under each innermost name, one nanosecond at a time."""
    out = {}
    for t in range(*window):
        if any(s <= t < e for s, e in busy):
            continue
        open_ = [(s, -e, n) for n, s, e in host
                 if n in names and s <= t < e]
        name = max(open_)[2] if open_ else bench_spans.OUTSIDE
        out[name] = out.get(name, 0) + 1
    return out


CASES = {
    # the fwd, a bwd holding two attention backwards, the update; busy
    # intervals cross every span boundary
    "nested": ([("train.fwd", 10, 40), ("train.bwd", 40, 90),
                ("attn.bwd", 50, 60), ("attn.bwd", 70, 85),
                ("train.optimizer", 92, 120), ("aten::add", 0, 130)],
               [(0, 12), (20, 30), (45, 55), (58, 72), (95, 100)]),
    # an attention backward that outlives its bwd (another thread), a
    # span wholly outside the window, idle before and after every span
    "overlapping": ([("train.bwd", 20, 60), ("attn.bwd", 50, 75),
                     ("train.fwd", 5, 25), ("train.optimizer", 200, 300)],
                    [(30, 52), (70, 72)]),
    # no step span at all: every name absent, all idle outside
    "none": ([("portbench.train_step", 0, 100), ("aten::mm", 3, 9)],
             [(10, 20)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_idle_partition_is_exact(case):
    host, busy = CASES[case]
    window = (0, 130)
    trace = SimpleNamespace(host=host, host_busy=busy, host_window=window)
    names = bench_spans.STEP_SPANS
    got = bench_spans.idle_ns(trace, names)
    want = _brute(host, busy, window, names)
    held = {n for n, _, _ in host if n in names}
    assert set(got) == held | {bench_spans.OUTSIDE}
    assert {n: v for n, v in got.items() if v} == want
    idle = (window[1] - window[0]) - sum(e - s for s, e in busy)
    assert sum(got.values()) == idle
    r = SimpleNamespace(trace=trace, traced_work=[(1, 1)] * 2)
    for n in names:
        ms = bench_spans.idle_ms_a_step(r, n)
        assert (ms is None) == (n not in held)
        if ms is not None:
            assert ms == got[n] / 1e6 / 2
    assert bench_spans.idle_ms_a_step(
        SimpleNamespace(trace=None, traced_work=[]), "train.fwd") is None
