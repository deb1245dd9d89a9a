"""The port's training step against the JAX reference on the CPU:
``models.api.loss_fn`` (the chunked LM loss, labels -1 ignored) and one
and several ``train.steps.make_train_step`` steps with AdamW, with
``microbatches`` 1 and 2 and ``grad_compression="fp16"``; and the port's
three remat policies, which must give equal results (the last two,
with microbatches, compression and the optimizer state carried from the
reference, in ``tests/test_torch_train_step_accum.py``).  The reference runs
jitted on a ``MeshContext`` built on Auto axes (its
``local_mesh_context()`` makes Explicit axes under this jax, ROADMAP
Queue 3); its parameters cross through ``interop.lm_params_from_numpy``,
the batch is made with numpy from a seed.  The model is
``reduce_for_smoke(llama3.2-1b)``: 2 layers, d_model 64, 4 heads of 16.

Tolerances:

* f32 parameters (the algorithm): the loss within 1e-5 relative; AdamW
  moments within 1e-5 + 1e-4 of their magnitude (f32 gradients in
  another summation order); parameters 99.9 % within the same and every
  one within 2 lr of the reference: Adam moves an element by
  lr g / (|g| + 1e-8), which for a gradient near 1e-8 turns a 1e-5
  relative difference of g into a fraction of lr;
* bf16 parameters (the working type): the loss within 2e-2; after a
  step, 99 % of the parameters within one bf16 ulp (2^-7 relative +
  1e-6) and every one within 2 lr + one ulp: an Adam update is about
  +-lr an element at first, and a bf16 gradient near zero may take the
  other sign on the other side.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as j_get_model_config
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.dist.meshctx import MeshContext
from repro.models import api as j_api
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import api
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.steps import make_eval_step, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 4, 16
LR = 5e-3
OPT = dict(lr=LR, warmup_steps=2)


@pytest.fixture(scope="module")
def ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return MeshContext(mesh=mesh, rules=JShardingConfig().lookup())


@pytest.fixture(scope="module")
def cfgs():
    return (j_reduce_for_smoke(j_get_model_config("llama3.2-1b")),
            reduce_for_smoke(get_model_config("llama3.2-1b")))


def _runs(cfgs, **kw):
    jcfg, cfg = cfgs
    opt = kw.pop("optimizer", {})
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"),
                       optimizer=JOptimizerConfig(**OPT, **opt), **kw),
            RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                      optimizer=OptimizerConfig(**OPT, **opt), **kw))


@functools.lru_cache(maxsize=None)
def _j_params(dtype):
    jcfg = j_reduce_for_smoke(j_get_model_config("llama3.2-1b"))
    jp = j_api.init_params(jcfg, jax.random.key(0))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp


def _params(cfgs, dtype):
    jp = _j_params(dtype)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfgs[1],
                                    device="cpu")


def _batch(step, vocab=256):
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[rng.random(labels.shape) < 0.1] = -1        # ignored positions
    b = {"tokens": toks[:, :-1], "labels": labels}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close_f32(got, want, what):
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    excess = np.abs(g - w) - (1e-5 + 1e-4 * np.abs(w))
    assert excess.max() <= 0, f"{what}: max excess {excess.max()}"


def _close_f32_after_step(got, want, what):
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    tight = 1e-5 + 1e-4 * np.abs(w)
    diff = np.abs(g - w)
    assert (diff <= tight).mean() >= 0.999, f"{what}: {(diff > tight).mean()}"
    assert (diff <= 2 * LR).all(), f"{what}: max {diff.max()}"


def _close_bf16_after_step(got, want, what):
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    ulp = 2 ** -7 * np.abs(w) + 1e-6
    diff = np.abs(g - w)
    assert (diff <= ulp).mean() >= 0.99, f"{what}: {(diff > ulp).mean()}"
    assert (diff <= 2 * LR + ulp).all(), f"{what}: max {diff.max()}"


def _tree_close(got, want, close, what=""):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(leaves) == len(flat)
    for (path, w), g in zip(flat, leaves):
        close(g, w, what + jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_equals_reference(ctx, cfgs, dtype):
    jcfg, cfg = cfgs
    jp, p = _params(cfgs, dtype)
    jb, b = _batch(0)
    jloss, jm = jax.jit(lambda p_, b_: j_api.loss_fn(
        jcfg, p_, b_, ctx, remat="none"))(jp, jb)
    loss, m = api.loss_fn(cfg, p, b, remat="none")
    assert loss.dtype == torch.float32
    assert float(m["tokens"]) == float(jm["tokens"]) == float(
        (b["labels"] >= 0).sum())
    assert float(m["aux"]) == 0.0
    tol = 1e-5 * abs(float(jloss)) if dtype == "float32" else 2e-2
    assert abs(float(loss) - float(jloss)) <= tol
    assert abs(float(m["loss"]) - float(jm["loss"])) <= tol
    em = make_eval_step(_runs(cfgs)[1])(p, b)
    assert float(em["loss"]) == float(m["loss"])


def _run_both(ctx, cfgs, dtype, steps, **kw):
    jrun, run = _runs(cfgs, remat="none", **kw)
    jp, p = _params(cfgs, dtype)
    jstep, jopt = j_make_train_step(jrun, ctx)
    jstep = jax.jit(jstep)
    step, opt = make_train_step(run)
    js, s = jopt.init(jp), opt.init(p)
    losses = []
    for i in steps:
        jb, b = _batch(i)
        jp, js, jm = jstep(jp, js, jb, jnp.int32(i))
        p, s, m = step(p, s, b, i)
        assert float(m["step"]) == float(jm["step"]) == i
        losses.append((float(m["loss"]), float(jm["loss"])))
    return (jp, js), (p, s), losses


@pytest.mark.parametrize("steps", [(3,), (0, 1, 2, 3)])
def test_train_steps_equal_reference_in_f32(ctx, cfgs, steps):
    (jp, js), (p, s), losses = _run_both(ctx, cfgs, "float32", steps)
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * abs(want)
    _tree_close(p, jp, _close_f32_after_step, "params")
    _tree_close(s, js, _close_f32, "opt")


def test_train_step_equals_reference_in_bf16(ctx, cfgs):
    (jp, js), (p, s), losses = _run_both(ctx, cfgs, "bfloat16", (3,))
    assert abs(losses[0][0] - losses[0][1]) <= 2e-2
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p))
    _tree_close(p, jp, _close_bf16_after_step, "params")
