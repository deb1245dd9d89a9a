"""The torch port's dense LM stack (``models/layers.py``, ``models/api.py``,
``serve/engine.py``, ``configs``) against the JAX reference on the CPU.

The same weights (drawn by the reference, handed across as numpy through
``interop.lm_params_from_numpy``) and the same tokens go through both.
Two tolerances:

* f32 (the algorithm; the reference's bf16 weights cast to f32 on both
  sides): max-abs 2e-5 + 1e-5 of the magnitude — exact arithmetic in
  another summation order;
* bf16 (the working type): max-abs 3e-2 + 2^-6 of the magnitude — bf16
  keeps 8 significant bits, so an activation may round one or two ulps
  apart (2^-7 of its magnitude each) and a layer carries that on.

The reference's ``MeshContext`` is built on Auto axes: its own
``local_mesh_context()`` makes Explicit axes under this jax, and then its
``with_sharding_constraint`` refuses them (ROADMAP Queue 3).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.configs import get_model_config as j_get_model_config
from repro.configs import get_run_config as j_get_run_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.dist.meshctx import MeshContext
from repro.models import api as j_api
from repro.models import layers as j_layers
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro_torch import configs
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import api, layers
from repro_torch.serve.engine import greedy_generate
from _torch_threads import one_torch_thread  # noqa: F401

BASE = dict(arch_id="lm-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            head_dim=16, tie_embeddings=True)
VARIANTS = {
    "swiglu_tied": {},
    "qkv_bias": dict(qkv_bias=True),
    "gelu_untied": dict(mlp_type="gelu", tie_embeddings=False),
}
B, S, MAX_SEQ = 2, 16, 24


@pytest.fixture(scope="module")
def ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return MeshContext(mesh=mesh, rules=JShardingConfig().lookup())


def _close(got, want, dtype):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol, rtol = (2e-5, 1e-5) if dtype == "float32" else (3e-2, 2 ** -6)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, f"max excess {excess.max()} ({dtype})"


def _models(variant, dtype, seed=0):
    """(reference cfg, reference params, port cfg, port params)."""
    kw = dict(BASE, **VARIANTS[variant])
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = j_api.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    if jcfg.qkv_bias:          # zero-initialised: give the biases values
        for name in ("bq", "bk", "bv"):
            a = jp["layers"]["attn"][name]
            jp["layers"]["attn"][name] = jnp.asarray(
                rng.standard_normal(a.shape) * 0.5, a.dtype)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, jp, cfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _tokens(seed=0, s=S):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab_size"], (B, s)).astype(np.int32)


def _activations(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


# ------------------------------------------------------------- small ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_equal_reference(dtype):
    jx, x = _activations((B, S, 4, 16), dtype, seed=1)
    jg, g = _activations((16,), dtype, seed=2)
    _close(layers.rms_norm(x, g), j_layers.rms_norm(jx, jg), dtype)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0) * 37
    _close(layers.apply_rope(x, torch.from_numpy(pos), 5e5),
           j_layers.apply_rope(jx, jnp.asarray(pos), 5e5), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["swiglu_tied", "gelu_untied"])
def test_mlp_equals_reference(ctx, variant, dtype):
    jcfg, jp, cfg, p = _models(variant, dtype)
    jh, h = _activations((B, S, 64), dtype, seed=3)
    take = lambda t: jax.tree.map(lambda a: a[0], t)     # noqa: E731
    _close(api._apply_mlp(layers.layer(p["layers"]["mlp"], 0), h, cfg),
           j_api._apply_mlp(take(jp["layers"]["mlp"]), jh, jcfg, ctx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["swiglu_tied", "qkv_bias"])
def test_mha_flash_equals_reference_flash_and_hier(ctx, variant, dtype):
    """The port's prefill attention (the kernel's path) against the
    reference's Pallas kernel in interpret mode and against the "hier"
    schedule the reference's prefill runs."""
    jcfg, jp, cfg, p = _models(variant, dtype)
    jx, x = _activations((B, S, 64), dtype, seed=4)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    y, (k, v) = layers.mha(layers.layer(p["layers"]["attn"], 0), x, cfg,
                           positions=torch.from_numpy(pos), return_kv=True)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    for impl in ("pallas_flash", "hier"):
        jy, (jk, jv) = j_layers.mha(jattn, jx, jcfg, ctx,
                                    positions=jnp.asarray(pos),
                                    attn_impl=impl, return_kv=True)
        _close(y, jy, dtype)
    _close(k, jk, dtype)
    _close(v, jv, dtype)


@pytest.mark.parametrize("impl", ["flash", "chunked", "hier"])
def test_mha_unported_schedules_raise(ctx, impl):
    """The three schedules that raised until training was ported now run:
    each equals the reference's ``mha`` with the same schedule (both
    dtypes), and gradients flow through it, where the backward through
    ``"pallas_flash"`` (no VJP, as the reference's Pallas call) raises."""
    for dtype in ("float32", "bfloat16"):
        jcfg, jp, cfg, p = _models("swiglu_tied", dtype)
        jx, x = _activations((B, S, 64), dtype, seed=11)
        pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
        attn = {k: t.clone().requires_grad_() for k, t in
                layers.layer(p["layers"]["attn"], 0).items()}
        y = layers.mha(attn, x, cfg, positions=torch.from_numpy(pos),
                       q_chunk=8, kv_chunk=8, attn_impl=impl)
        jy = j_layers.mha(jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
                          jx, jcfg, ctx, positions=jnp.asarray(pos),
                          q_chunk=8, kv_chunk=8, attn_impl=impl)
        _close(y, jy, dtype)
        y.float().square().sum().backward()
        assert all(torch.isfinite(t.grad.float()).all() and
                   t.grad.abs().sum() > 0 for t in attn.values())


def test_pallas_flash_backward_raises():
    _, _, cfg, p = _models("swiglu_tied", "float32")
    attn = {k: t.clone().requires_grad_() for k, t in
            layers.layer(p["layers"]["attn"], 0).items()}
    _, x = _activations((B, S, 64), "float32", seed=12)
    y = layers.mha(attn, x, cfg, positions=torch.zeros(
        (B, S), dtype=torch.int32), attn_impl="pallas_flash")
    with pytest.raises(NotImplementedError, match="no backward"):
        y.sum().backward()
    with pytest.raises(ValueError, match="unknown attn_impl"):
        layers.mha(attn, x, cfg, positions=torch.zeros((B, S),
                   dtype=torch.int32), attn_impl="ring")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_decode_updates_cache_in_place_like_reference(ctx, dtype):
    jcfg, jp, cfg, p = _models("swiglu_tied", dtype)
    jx, x = _activations((B, 1, 64), dtype, seed=5)
    jck, ck = _activations((B, MAX_SEQ, 2, 16), dtype, seed=6)
    jcv, cv = _activations((B, MAX_SEQ, 2, 16), dtype, seed=7)
    pos = 9
    cache = {"k": ck, "v": cv}
    y, out = layers.mha_decode(layers.layer(p["layers"]["attn"], 0), x,
                               cache, cfg, pos=pos)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jy, jout = j_layers.mha_decode(jattn, jx, {"k": jck, "v": jcv}, jcfg, ctx,
                                   pos=jnp.int32(pos))
    _close(y, jy, dtype)
    assert out["k"] is ck and out["v"] is cv            # updated in place
    _close(ck, jout["k"], dtype)
    _close(cv, jout["v"], dtype)


# ------------------------------------------------------ prefill / decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_equal_reference(ctx, variant, dtype):
    jcfg, jp, cfg, p = _models(variant, dtype)
    toks = _tokens()
    jl, jc = j_api.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, ctx,
                           max_seq=MAX_SEQ)
    logits, cache = api.prefill(cfg, p, {"tokens": torch.from_numpy(toks)},
                                max_seq=MAX_SEQ)
    assert logits.dtype == torch.float32
    _close(logits, jl, dtype)
    for name in ("k", "v"):       # the prompt's keys, then zero padding
        _close(cache["attn"][name], jc["attn"][name], dtype)
        assert not cache["attn"][name][:, :, S:].any()
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    jl2, _ = j_api.decode_step(jcfg, jp, jnp.asarray(nxt), jnp.int32(S), jc,
                               ctx)
    logits2, cache2 = api.decode_step(cfg, p, torch.from_numpy(nxt), S,
                                      cache)
    assert cache2 is cache
    _close(logits2, jl2, dtype)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_tokens_equal_reference_in_f32(ctx, variant):
    jcfg, jp, cfg, p = _models(variant, "float32")
    toks = _tokens(seed=2)
    want = j_greedy_generate(
        JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "decode")), ctx,
        jp, jnp.asarray(toks), steps=6, max_seq=MAX_SEQ)
    got = greedy_generate(
        RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "decode")), p,
        torch.from_numpy(toks), steps=6, max_seq=MAX_SEQ)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_continues_prefill(dtype):
    """Decode at position S after prefill(S) gives the logits prefill(S+1)
    gives at its last position."""
    _, _, cfg, p = _models("swiglu_tied", dtype)
    toks = torch.from_numpy(_tokens(seed=3, s=S + 1))
    _, cache = api.prefill(cfg, p, {"tokens": toks[:, :S]}, max_seq=S + 1)
    got, _ = api.decode_step(cfg, p, toks[:, S:], S, cache)
    want, _ = api.prefill(cfg, p, {"tokens": toks})
    _close(got, want, dtype)


def test_greedy_generate_refuses_a_short_cache():
    _, _, cfg, p = _models("swiglu_tied", "float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "decode"))
    with pytest.raises(ValueError, match="max_seq"):
        greedy_generate(run, p, torch.from_numpy(_tokens()), steps=10,
                        max_seq=S + 4)


# --------------------------------------------------------------- configs


def test_llama_template_equals_reference_without_allocating():
    cfg = configs.get_model_config("llama3.2-1b")
    jcfg = j_get_model_config("llama3.2-1b")
    port = dataclasses.asdict(cfg)
    # the port's own fields (for models the reference lacks) at their
    # defaults; every other field the reference's
    own = {f.name: f.default for f in dataclasses.fields(cfg)
           if not hasattr(jcfg, f.name)}
    assert set(own) == {"mla", "first_dense_layers", "sigmoid_moe"}
    assert {f: port.pop(f) for f in own} == own
    assert port == {f: getattr(jcfg, f) for f in port}
    # the reference's fields the port leaves out are unused by llama3.2-1b
    assert (jcfg.moe, jcfg.ssm, jcfg.xlstm, jcfg.frontend, jcfg.attn_every) \
        == (None, None, None, "none", 0)
    shapes = {}

    def walk(t, path):
        if isinstance(t, layers.ParamSpec):
            shapes[path] = (t.shape, t.dtype)
        else:
            for k, v in t.items():
                walk(v, f"{path}/{k}")
    walk(api.param_template(cfg), "")
    want = {}
    flat = jax.tree_util.tree_flatten_with_path(
        j_api.param_template(jcfg), is_leaf=j_layers.is_spec)[0]
    for kp, spec in flat:
        want["".join(f"/{k.key}" for k in kp)] = (spec.shape, spec.dtype)
    assert shapes == want
    assert cfg.param_count() == jcfg.param_count() == 1_235_814_400
    assert jcfg.active_param_count() == cfg.param_count()
    assert 2 * cfg.param_count() / 1e9 == pytest.approx(2.47, abs=0.01)


def test_registry_ports_llama_only_and_names_the_queue():
    """Every architecture of the reference is ported now: the registry
    lists the reference's ten in its order, every family builds a
    template, and an unknown arch still raises ``KeyError``."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    assert configs.ARCH_IDS == J_ARCH_IDS and len(configs.ARCH_IDS) == 10
    assert configs.get_model_config("llama3.2-1b").num_layers == 16
    assert not hasattr(configs, "NOT_PORTED")
    assert not hasattr(api, "PORTED_FAMILIES")
    with pytest.raises(KeyError, match="unknown"):
        configs.get_model_config("gpt-2")
    for fam in ("moe", "ssm", "hybrid", "vlm", "audio"):
        kw = dict(BASE, family=fam)
        if fam in ("vlm", "audio"):
            kw.update(frontend="vision_patches" if fam == "vlm"
                      else "audio_frames", frontend_dim=32)
        cfg = ModelConfig(**kw, **{
            "moe": dict(moe=configs.MoEConfig(4, 2, 16)),
            "ssm": dict(xlstm=configs.XLSTMConfig()),
            "hybrid": dict(ssm=configs.SSMConfig(16, 4, 2, 16, 16),
                           attn_every=1),
        }.get(fam, {}))
        jcfg = JModelConfig(**{f: getattr(cfg, f) for f in (
            "arch_id", "family", "num_layers", "d_model", "num_heads",
            "num_kv_heads", "d_ff", "vocab_size", "head_dim",
            "tie_embeddings", "attn_every", "frontend", "frontend_dim")},
            **{"moe": dict(moe=j_configs.MoEConfig(4, 2, 16)),
               "ssm": dict(xlstm=j_configs.XLSTMConfig()),
               "hybrid": dict(ssm=j_configs.SSMConfig(16, 4, 2, 16, 16))
               }.get(fam, {}))
        assert cfg.param_count() == jcfg.param_count(), fam


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_run_config_equals_reference(shape):
    """``get_run_config``: the reference's shape, optimizer and overrides
    (the fields the port keeps, field by field)."""
    run = configs.get_run_config("llama3.2-1b", shape, remat="selective",
                                 microbatches=2)
    jrun = j_get_run_config("llama3.2-1b", shape, remat="selective",
                            microbatches=2)
    assert run.model == configs.get_model_config("llama3.2-1b")
    assert dataclasses.asdict(run.shape) == dataclasses.asdict(jrun.shape)
    assert run.shape.tokens == jrun.shape.tokens
    jopt = dataclasses.asdict(jrun.optimizer)
    for f in dataclasses.fields(run.optimizer):
        assert getattr(run.optimizer, f.name) == jopt[f.name], f.name
    assert (run.remat, run.microbatches, run.seed) == (
        jrun.remat, jrun.microbatches, jrun.seed)
    with pytest.raises(KeyError):
        configs.get_run_config("gpt-2", shape)


def test_lm_params_from_numpy_refuses_a_mismatched_tree():
    jcfg, jp, cfg, _ = _models("swiglu_tied", "bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    p = lm_params_from_numpy(tree, cfg, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    assert np.array_equal(p["embed"].view(torch.int16).numpy(),
                          tree["embed"].view(np.int16))     # bit for bit
    bad = dict(tree, embed=tree["embed"][:, :32])
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(dict(tree, extra=tree["embed"]), cfg,
                             device="cpu")


def test_init_params_draws_from_the_generator():
    cfg = ModelConfig(**BASE)
    a = api.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = api.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert a["embed"].dtype == torch.bfloat16
    assert float(a["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    wq = a["layers"]["attn"]["wq"].float()
    assert float(wq.std()) == pytest.approx(1 / math.sqrt(64), rel=0.1)
    assert torch.equal(a["final_norm"], torch.ones(64, dtype=torch.bfloat16))
