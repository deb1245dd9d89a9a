"""Shared checks of the port's train step for the families beyond the
dense one (moe, hybrid, ssm, and the vlm and audio front ends) against
the JAX reference on the CPU (``tests/test_torch_train_families_*.py``,
one file a family so that each runs in well under a minute).

Setup: each family at its ``reduce_for_smoke`` form, the reference's
weights crossing through ``interop.lm_params_from_numpy`` and the
tokens, labels, patches or frames made with numpy from a seed
(``models``/``batches`` of ``tests/_torch_families.py``); the reference's
``make_train_step`` jitted on a ``MeshContext`` built on Auto axes, the
port's ``make_train_step`` on the CPU (its attention the flash Function's
plain forward and block-recompute backward), AdamW at lr 5e-3 with two
warm-up steps.

What is held, and within what (``TOL``):

* :func:`check_grads`, f32, remat "none": the loss (``loss + 0.01 aux``)
  within 1e-5 relative, the aux loss and the token count, and every
  gradient leaf, each element within ``atol`` times the leaf's largest
  |g| plus ``rtol`` |g|: (1e-4, 1e-4) for the f32 families (sums in
  another order; read: at most 1.2e-5 of the leaf's largest), (8e-3,
  2^-8) for the MoE, whose combine rounds to bf16 on both sides (the
  reference's bf16 ``psum``): an output element within float error of a
  rounding boundary rounds one ulp apart, 2^-8 of it, and its gradient
  path carries that on (read: at most 1.7e-3 of the leaf's largest, in
  ``wd``).  The port's remat "full" must give the same loss and
  gradients as "none", bit for bit (remat changes memory only).
* :func:`check_steps`, two AdamW steps in f32 (steps 1 and 2 of the
  warm-up; step 0's rate is 0): the second step's loss within 1e-5
  relative (the MoE 1e-4, read 2.1e-5), every parameter within 2 lr of
  the reference (Adam moves an element by lr g / (|g| + 1e-8): a
  gradient near zero may flip the update's sign) and all but
  ``FRAC_OFF`` of them (or 2 elements of a small leaf) within 1e-5 +
  1e-4 |w|: 1 % (read: at most 0.2 %, one of xLSTM's 512 ``w_f``
  elements, and 2 of its 64 zero-initialised sLSTM ``b_i``: gradients
  near zero), the MoE 10 % (read 5.6 %, in ``wq``: the combine's flips,
  above, move gradients near zero); the moments within ``MOMENT_TOL``,
  scaled as the gradients, (1e-3, 1e-4) (read: at most 1.1e-4 of the
  leaf's largest, zamba2's embedding) and the MoE's (1e-2, 2^-8) (read
  3.8e-3), the second moment at twice either (it squares them).
* :func:`check_step_bf16`, one step in bf16 against the reference's
  step jitted in a subprocess that rounds every bf16 intermediate as its
  eager form does (:func:`reference_bf16_steps`): 99 % of the bf16
  parameters within one bf16 ulp (2^-7 |w| + 1e-6), every one within 2
  lr + one ulp; the f32 leaves as after the f32 steps.
* :func:`check_microbatches`, ``microbatches=2`` in f32, one step: the
  reference keeps only "loss" (and "step") in its metrics, and so must
  the port; the loss (each microbatch's ``loss + 0.01 aux``, averaged)
  and the parameters as in :func:`check_steps`.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import api as j_api
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.train.steps import make_train_step
from _torch_families import B, S, _leaves, batches, models

LR = 5e-3
OPT = dict(lr=LR, warmup_steps=2)
#: gradient leaves: (atol as a share of the leaf's largest |g|, rtol)
TOL = {"float32": (1e-4, 1e-4), "moe": (8e-3, 2 ** -8)}
#: the share of parameters and moments allowed past the tight bound after
#: the f32 steps (all stay within 2 lr)
FRAC_OFF = {"float32": 1e-2, "moe": 0.1}
#: the moments after the two steps, as TOL: the second step's gradients
#: are taken at parameters that already differ (above)
MOMENT_TOL = {"float32": (1e-3, 1e-4), "moe": (1e-2, 2 ** -8)}
#: the loss after the first step, relative
LOSS_RTOL = {"float32": 1e-5, "moe": 1e-4}


def _kind(cfg):
    return "moe" if cfg.family == "moe" else "float32"


def runs(jcfg, cfg, **kw):
    """(reference RunConfig, port RunConfig) at (B, S), AdamW at ``LR``,
    remat "none" unless ``kw`` says otherwise."""
    kw.setdefault("remat", "none")
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"),
                       optimizer=JOptimizerConfig(**OPT), **kw),
            RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                      optimizer=OptimizerConfig(**OPT), **kw))


def port_loss_and_grads(cfg, params, batch, remat="none"):
    """The port's ``loss_fn`` and its gradients over every leaf -> (loss,
    metrics, grads), the grads a tree like ``params``."""
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(live)
    loss, metrics = api.loss_fn(cfg, tree_map(lambda _: next(it), params),
                                batch, remat=remat)
    grads = iter(torch.autograd.grad(loss, live))
    return loss.detach(), metrics, tree_map(lambda _: next(grads), params)


def _flat(tree):
    """{path: leaf}; a dict already flat (its keys paths) stays as it is."""
    if all(isinstance(k, str) and k.startswith("/") for k in tree):
        return tree
    return dict(_leaves(tree))


def _pairs(got, want):
    """(path, port leaf, reference leaf) in f32 numpy; each a tree or a
    flat {path: leaf}."""
    got = _flat(got)
    want = _flat(jax.tree.map(np.asarray, want))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in sorted(want):
        yield k, got[k].detach().float().numpy(), np.asarray(want[k],
                                                              np.float32)


def _close_scaled(got, want, tol, what):
    """Each element within atol * max|want| + rtol * |want|."""
    atol, rtol = tol
    for k, g, w in _pairs(got, want):
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        excess = np.abs(g - w) - (atol * np.abs(w).max() + rtol * np.abs(w))
        assert excess.max() <= 0, f"{what}{k}: max excess {excess.max()}"


def _close_after_steps(got, want, kind, what):
    for k, g, w in _pairs(got, want):
        diff = np.abs(g - w)
        off = int((diff > 1e-5 + 1e-4 * np.abs(w)).sum())
        assert off <= max(FRAC_OFF[kind] * diff.size, 2), \
            f"{what}{k}: {off} of {diff.size} past the bound"
        assert (diff <= 2 * LR).all(), f"{what}{k}: max {diff.max()}"


def _close_bf16_after_step(got, want, what):
    for k, g, w in _pairs(got, want):
        ulp = 2 ** -7 * np.abs(w) + 1e-6
        diff = np.abs(g - w)
        assert (diff <= ulp).mean() >= 0.99, f"{what}{k}: " \
            f"{(diff > ulp).mean()} past one ulp"
        assert (diff <= 2 * LR + ulp).all(), f"{what}{k}: max {diff.max()}"


def check_grads(ctx, arch, **overrides):
    """Loss, aux, tokens and every gradient leaf in f32 against the
    reference's ``value_and_grad``; remat "full" equal to "none"."""
    jcfg, jp, cfg, p = models(arch, "float32", seed=3, **overrides)
    jb, pb = batches(cfg, "float32", seed=4)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p_, b_: j_api.loss_fn(jcfg, p_, b_, ctx, remat="none"),
        has_aux=True))(jp, jb)
    loss, m, g = port_loss_and_grads(cfg, p, pb)
    m = {k: v.detach() for k, v in m.items()}
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(m["tokens"]) == float(jm["tokens"])
    aux_tol = TOL[_kind(cfg)]
    assert abs(float(m["aux"]) - float(jm["aux"])) <= \
        aux_tol[0] * 1e-2 + aux_tol[1] * abs(float(jm["aux"]))
    if cfg.family == "moe":
        assert float(m["aux"]) > 0
    _close_scaled(g, jg, TOL[_kind(cfg)], f"{arch} grads")
    loss_f, m_f, g_f = port_loss_and_grads(cfg, p, pb, remat="full")
    assert torch.equal(loss_f, loss) and torch.equal(m_f["aux"].detach(),
                                                     m["aux"])
    for a, b in zip(tree_leaves(g_f), tree_leaves(g)):
        assert torch.equal(a, b)
    return g


def _step_both(ctx, arch, dtype, steps, overrides=None, **run_kw):
    jcfg, jp, cfg, p = models(arch, dtype, seed=3, **(overrides or {}))
    jrun, run = runs(jcfg, cfg, **run_kw)
    jstep, jopt = j_make_train_step(jrun, ctx)
    jstep = jax.jit(jstep)
    step, opt = make_train_step(run)
    js, s = jopt.init(jp), opt.init(p)
    out = []
    for i in steps:
        jb, pb = batches(cfg, dtype, seed=10 + i)
        jp, js, jm = jstep(jp, js, jb, jnp.int32(i))
        p, s, m = step(p, s, pb, i)
        assert float(m["step"]) == float(jm["step"]) == i
        out.append((m, jm))
    return (jp, js), (p, s), out


def check_steps(ctx, arch, steps=(1, 2), **overrides):
    """Two AdamW steps in f32: losses, parameters and moments."""
    (jp, js), (p, s), metrics = _step_both(ctx, arch, "float32", steps,
                                           overrides)
    kind = "moe" if arch.startswith(("moonshot", "kimi")) else "float32"
    for m, jm in metrics:
        assert set(m) == set(jm), (sorted(m), sorted(jm))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL[kind] * abs(float(jm["loss"]))
    _close_after_steps(p, jp, kind, f"{arch} params")
    _close_scaled(s["m"], js["m"], MOMENT_TOL[kind], f"{arch} m")
    _close_scaled(s["v"], js["v"], tuple(2 * t for t in MOMENT_TOL[kind]),
                  f"{arch} v")


#: XLA's flag that makes a jitted bf16 program round every intermediate to
#: bf16 as the same ops run one at a time do (by default XLA keeps fused
#: intermediates in f32, ``xla_allow_excess_precision``)
EXACT_BF16_XLA_FLAGS = "--xla_allow_excess_precision=false"
_ROOT = Path(__file__).resolve().parent.parent

_REFERENCE_STEPS = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from _torch_families import make_ctx
from _torch_train_families import reference_bf16_step
ctx = make_ctx()
for arch in sys.argv[3:]:
    np.savez(f"{sys.argv[2]}/{arch}.npz", **reference_bf16_step(ctx, arch))
"""


def _bf16_step_inputs(arch):
    jcfg, jp, cfg, p = models(arch, "bfloat16", seed=3)
    jb, pb = batches(cfg, "bfloat16", seed=12)
    return jcfg, jp, jb, cfg, p, pb


def reference_bf16_step(ctx, arch):
    """The reference's jitted train step of :func:`check_step_bf16` ->
    {"loss": 0-d, each parameter's path: its values in f32}."""
    jcfg, jp, jb, cfg, _, _ = _bf16_step_inputs(arch)
    jrun, _ = runs(jcfg, cfg)
    jstep, jopt = j_make_train_step(jrun, ctx)
    jp, _, jm = jax.jit(jstep)(jp, jopt.init(jp), jb, jnp.int32(3))
    return {"loss": np.asarray(jm["loss"], np.float32),
            **{k: np.asarray(v, np.float32) for k, v in _leaves(
                jax.tree.map(np.asarray, jp))}}


def reference_bf16_steps(out_dir, archs):
    """:func:`reference_bf16_step` of each of ``archs``, run in ONE
    subprocess under :data:`EXACT_BF16_XLA_FLAGS` -> {arch: its dict}.
    With XLA's default excess precision the jitted step keeps fused bf16
    intermediates in f32: the MoE block then routes a token to another
    expert than the same block run eagerly (whose bf16 results the port
    matches bit for bit), and the Mamba2 and sLSTM stacks move 2.5-4 % of
    the parameters a bf16 ulp or more from the eager step; under the flag
    the jitted step's loss equals the eager step's (MoE, xLSTM)."""
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=EXACT_BF16_XLA_FLAGS)
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_STEPS, str(_ROOT / "tests"),
         str(out_dir), *archs], env=env, cwd=_ROOT, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return {a: dict(np.load(Path(out_dir) / f"{a}.npz")) for a in archs}


def check_step_bf16(arch, want):
    """One step in bf16 against ``want``, the reference's step of
    :func:`reference_bf16_steps`: the loss within 2e-2, the bf16
    parameters within one bf16 ulp (99 %) and 2 lr + one ulp (all), the
    f32 ones (the MoE router, the Mamba2 and sLSTM gate constants) as
    after the f32 steps (Adam's eps regime: a zero-initialised bias moves
    by lr g / (|g| + 1e-8) with |g| near 1e-8)."""
    _, _, _, cfg, p, pb = _bf16_step_inputs(arch)
    dtypes = {k: t.dtype for k, t in _leaves(p)}
    step, opt = make_train_step(runs(None, cfg)[1])
    p, _, m = step(p, opt.init(p), pb, 3)
    want = dict(want)
    assert abs(float(m["loss"]) - float(want.pop("loss"))) <= 2e-2
    assert {k: t.dtype for k, t in _leaves(p)} == dtypes
    f32 = {k for k, d in dtypes.items() if d == torch.float32}
    _close_after_steps({k: t for k, t in _leaves(p) if k in f32},
                       {k: w for k, w in want.items() if k in f32},
                       _kind(cfg), f"{arch} bf16 step's f32 params")
    _close_bf16_after_step({k: t for k, t in _leaves(p) if k not in f32},
                           {k: w for k, w in want.items() if k not in f32},
                           f"{arch} bf16 params")


def check_microbatches(ctx, arch, **overrides):
    """``microbatches=2``: one f32 step, the reference's metrics keys."""
    (jp, _), (p, _), metrics = _step_both(ctx, arch, "float32", (2,),
                                          overrides, microbatches=2)
    (m, jm), = metrics
    assert set(m) == set(jm) == {"loss", "step"}, (sorted(m), sorted(jm))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    kind = "moe" if arch.startswith(("moonshot", "kimi")) else "float32"
    _close_after_steps(p, jp, kind, f"{arch} microbatched params")
