"""The port's training step against the JAX reference on the CPU, with
``microbatches`` 2 and ``grad_compression="fp16"``, a reference AdamW
state carried into the port, and the port's three remat policies, which
must give equal results.  Fixtures, helpers and tolerances are
``tests/test_torch_train_step.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.interop import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.steps import make_train_step
from test_torch_train_step import (_batch, _close_f32, _close_f32_after_step,
                                   _params, _run_both, _runs, _tree_close,
                                   cfgs, ctx)
from _torch_threads import one_torch_thread  # noqa: F401

__all__ = ["cfgs", "ctx"]          # the fixtures, shared


@pytest.mark.parametrize("kw", [dict(microbatches=2),
                                dict(optimizer=dict(grad_compression="fp16")),
                                dict(microbatches=2, optimizer=dict(
                                    grad_compression="fp16"))],
                         ids=["microbatches2", "fp16", "both"])
def test_accumulation_and_compression_equal_reference(ctx, cfgs, kw):
    (jp, js), (p, s), losses = _run_both(ctx, cfgs, "float32", (2, 3), **kw)
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * abs(want)
    _tree_close(p, jp, _close_f32_after_step, "params")
    _tree_close(s, js, _close_f32, "opt")


def test_microbatches_must_divide_the_batch(cfgs):
    _, run = _runs(cfgs, microbatches=3)
    _, p = _params(cfgs, "float32")
    step, opt = make_train_step(run)
    with pytest.raises(ValueError, match="microbatches"):
        step(p, opt.init(p), _batch(0)[1], 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policies_give_equal_results(cfgs, dtype):
    """Remat changes memory only: "none", "full" and "selective" give the
    same loss, parameters and moments, bit for bit."""
    _, p = _params(cfgs, dtype)
    _, b = _batch(1)
    out = {}
    for remat in ("none", "full", "selective"):
        step, opt = make_train_step(_runs(cfgs, remat=remat)[1])
        out[remat] = step(p, opt.init(p), b, 3)
    for remat in ("full", "selective"):
        for got, want in zip(tree_leaves(out[remat][0]) +
                             tree_leaves(out[remat][1]),
                             tree_leaves(out["none"][0]) +
                             tree_leaves(out["none"][1])):
            assert torch.equal(got, want), remat
        assert torch.equal(out[remat][2]["loss"], out["none"][2]["loss"])


def test_opt_state_crosses_from_the_reference(ctx, cfgs):
    """A reference AdamW state carried into the port (bit for bit) and
    one step on each side: the port continues the reference."""
    jrun, run = _runs(cfgs, remat="none")
    jp, p = _params(cfgs, "float32")
    jstep, jopt = j_make_train_step(jrun, ctx)
    jstep = jax.jit(jstep)
    jb0, _ = _batch(0)
    jp, js, _ = jstep(jp, jopt.init(jp), jb0, jnp.int32(3))
    step, opt = make_train_step(run)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfgs[1],
                             device="cpu")
    s = opt_state_from_numpy(jax.tree.map(np.asarray, js), opt.init(p),
                             device="cpu")
    for got, want in zip(tree_leaves(s), jax.tree.leaves(js)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    jb1, b1 = _batch(1)
    jp, js, _ = jstep(jp, js, jb1, jnp.int32(4))
    p, s, _ = step(p, s, b1, 4)
    _tree_close(p, jp, _close_f32_after_step, "params")
    _tree_close(s, js, _close_f32, "opt")
    with pytest.raises(ValueError, match="keys"):
        opt_state_from_numpy({"m": js["m"]}, opt.init(p), device="cpu")
