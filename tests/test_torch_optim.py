"""The port's optimizers (``optim/``) against the JAX reference on seeded
trees, over several steps: AdamW, Adafactor (factored over the last two
axes of a stacked 3-D leaf, unfactored where an axis is 1) and SGD with
bf16 momentum, with the global-norm clipping on and off, and the
warmup-cosine schedule.  The same gradients, made with numpy from a
seed, go to both at every step.  The reference runs eagerly: each jnp
op rounds its result to its type, as each torch op does (under ``jit``
XLA keeps the clipped bf16 gradient in f32 instead of rounding it, a
bf16-ulp difference that the train-step tests allow for).

Tolerances: f32 leaves |got - want| <= 1e-6 + 1e-5 |want| (f32 arithmetic
in the reference's order; ``b ** t`` and the cosine may round one ulp
apart); bf16 leaves one bf16 ulp, 2^-7 |want| + 1e-6 (an f32 value a ulp
apart can round to a neighbouring bf16 value); the schedule 1e-7 + 1e-6
of its value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.optim import make_optimizer as j_make_optimizer
from repro.optim import optimizers as j_optimizers
from repro.optim.schedules import warmup_cosine as j_warmup_cosine
from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.optim import optimizers
from _torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"a": ((3, 4), "float32"),
          "b": {"c": ((2, 3, 5), "bfloat16"),      # stacked (L, ...) leaf
                "d": ((7,), "float32"),
                "e": ((4, 1), "float32")}}
STEPS = 4


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    shape, dtype = shapes
    return (rng.standard_normal(shape) * scale).astype(np.float32), dtype


def _to_jax(t):
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    a, dtype = t
    return jnp.asarray(a, getattr(jnp, dtype))


def _to_torch(t):
    if isinstance(t, dict):
        return {k: _to_torch(v) for k, v in t.items()}
    a, dtype = t
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, path=""):
    if isinstance(got, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in got:
            _close(got[k], want[k], f"{path}/{k}")
        return
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    atol, rtol = (1e-6, 1e-5) if got.dtype == torch.float32 \
        else (1e-6, 2 ** -7)
    excess = np.abs(g - w) - (atol + rtol * np.abs(w))
    assert excess.max() <= 0, f"{path}: max excess {excess.max()}"


@pytest.mark.parametrize("clip", [1.0, 0.05])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_updates_equal_reference_over_steps(name, clip):
    kw = dict(name=name, lr=1e-2, warmup_steps=2, grad_clip=clip,
              weight_decay=0.1)
    opt, jopt = make_optimizer(OptimizerConfig(**kw)), \
        j_make_optimizer(JOptimizerConfig(**kw))
    rng = np.random.default_rng(["adamw", "adafactor", "sgdm"].index(name)
                                + int(100 * clip))
    p0 = _tree(SHAPES, rng)
    params, jparams = _to_torch(p0), _to_jax(p0)
    state, jstate = opt.init(params), jopt.init(jparams)
    _close(state, jstate)
    for step in range(STEPS):
        g = _tree(SHAPES, rng, scale=0.3)
        params, state = opt.update(_to_torch(g), state, params, step)
        jparams, jstate = jopt.update(_to_jax(g), jstate, jparams,
                                      jnp.int32(step))
        _close(params, jparams, f"{name} step {step} params")
        _close(state, jstate, f"{name} step {step} state")


def test_updates_build_new_tensors():
    """The step-0 snapshot of the trainer relies on it: an update leaves
    its inputs as they were."""
    opt = make_optimizer(OptimizerConfig(warmup_steps=0))
    rng = np.random.default_rng(0)
    params = _to_torch(_tree(SHAPES, rng))
    state = opt.init(params)
    before = [t.clone() for t in optimizers.tree_leaves(params)]
    m_before = [t.clone() for t in optimizers.tree_leaves(state["m"])]
    opt.update(_to_torch(_tree(SHAPES, rng)), state, params, 3)
    assert all(torch.equal(a, b) for a, b in
               zip(before, optimizers.tree_leaves(params)))
    assert all(torch.equal(a, b) for a, b in
               zip(m_before, optimizers.tree_leaves(state["m"])))


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_keeps_the_grads_type(max_norm):
    g0 = _tree(SHAPES, np.random.default_rng(5))
    got, norm = optimizers._clip_by_global_norm(_to_torch(g0), max_norm)
    want, jnorm = j_optimizers._clip_by_global_norm(_to_jax(g0), max_norm)
    _close(got, want)
    assert got["b"]["c"].dtype == torch.bfloat16
    assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
    assert float(optimizers._global_norm(_to_torch(g0))) == \
        pytest.approx(float(j_optimizers._global_norm(_to_jax(g0))),
                      rel=1e-6)


@pytest.mark.parametrize("warmup,total", [(100, 100_000), (0, 50), (7, 7)])
def test_warmup_cosine_equals_reference(warmup, total):
    for step in (0, 1, 6, 7, 50, 99, 100, 101, 5_000, 99_999, 100_000,
                 250_000):
        got = warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                            total_steps=total)
        want = j_warmup_cosine(jnp.int32(step), peak_lr=3e-4,
                               warmup_steps=warmup, total_steps=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want)) <= 1e-7 + 1e-6 * float(want), \
            (step, float(got), float(want))
