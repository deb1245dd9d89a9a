"""The port's ``Trainer`` (sealed data, sealed checkpoints, checkpoint-
restart) and ``ft.failures.run_with_recovery`` against the JAX
reference's on the CPU.

The reference ``Trainer`` runs on a ``MeshContext`` built on Auto axes
(its ``local_mesh_context()`` makes Explicit axes under this jax, ROADMAP
Queue 3) over ``reduce_for_smoke(llama3.2-1b)``, with f32 parameters on
both sides (set after construction): 6 steps, a sealed checkpoint every 2, sealed batches, and a
``node_loss`` injected at step 3, after the first checkpoint.

What must be equal exactly: the sealed data (ciphertext and tags of a
batch, the data edge's session key), the recovery bookkeeping (final
step, restarts, replayed steps, the steps of the history) and a
reference-written checkpoint as the port restores it.  What is held to
a tolerance: the losses, 1e-5 relative (f32 gradients summed in another
order), and the final parameters, 99.9 % within 1e-5 + 1e-4 of their
magnitude and every one within 6 steps x 2 lr (an Adam update moves an
element by about lr, and a gradient near 1e-8 turns a small difference
into a fraction of it).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.ckpt import checkpoint as j_ckpt
from repro.configs import get_model_config as j_get_model_config
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.core.enclave import ingress as j_ingress
from repro.dist.meshctx import MeshContext
from repro.ft import failures as j_failures
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.attest.directory import KeyDirectory
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.core.enclave import ingress
from repro_torch.ft import failures
from repro_torch.interop import lm_params_from_numpy
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 4, 16
LR = 5e-3
STEPS, CKPT_EVERY, FAIL_AT = 6, 2, 3
TCFG = dict(total_steps=STEPS, ckpt_every=CKPT_EVERY, log_every=1,
            sealed_ckpt=True, sealed_data=True, seed=3)


def data_fn(step):
    """The learnable recipe of ``examples/secure_lm_train.py``."""
    rng = np.random.default_rng(1000 + step)
    start = rng.integers(0, 256, (B, 1))
    ramp = (start + np.arange(S + 1)[None]) % 256
    noise = rng.integers(0, 256, ramp.shape)
    keep = rng.random(ramp.shape) < 0.9
    toks = np.where(keep, ramp, noise).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _runs():
    opt = dict(lr=LR, warmup_steps=2)
    jcfg = j_reduce_for_smoke(j_get_model_config("llama3.2-1b"))
    cfg = reduce_for_smoke(get_model_config("llama3.2-1b"))
    return (JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"),
                       optimizer=JOptimizerConfig(**opt), remat="none"),
            RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                      optimizer=OptimizerConfig(**opt), remat="none"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One reference run with the failure: its output, final parameters
    (numpy), initial parameters (numpy) and checkpoint directory."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ctx = MeshContext(mesh=mesh, rules=JShardingConfig().lookup())
    jrun, _ = _runs()
    ckdir = tmp_path_factory.mktemp("ref") / "ck"
    tr = JTrainer(jrun, ctx, data_fn,
                  JTrainerConfig(ckpt_dir=str(ckdir), **TCFG),
                  injector=j_failures.FailureInjector({FAIL_AT: "node_loss"}))
    tr.params = jax.tree.map(lambda a: a.astype(jnp.float32), tr.params)
    tr.opt_state = tr.opt.init(tr.params)
    tr._init_params = jax.tree.map(jnp.array, tr.params)
    tr._init_opt_state = jax.tree.map(jnp.array, tr.opt_state)
    init = jax.tree.map(np.asarray, tr.params)
    key = np.asarray(tr._data_key.key)
    batch = {k: np.asarray(v) for k, v in tr._sealed_batch(1).items()}
    out = tr.train()
    return dict(out=out, final=jax.tree.map(np.asarray, tr.params),
                init=init, ckdir=ckdir, key=key, batch=batch)


def _port(tmp_path, init, *, injector=None, ckdir=None, **kw):
    """The port's Trainer with the reference's initial parameters, set
    after construction as the reference's are (its own draw differs)."""
    _, run = _runs()
    cfg = dict(TCFG, **kw)
    tr = Trainer(run, data_fn,
                 TrainerConfig(ckpt_dir=str(ckdir or tmp_path / "ck"), **cfg),
                 injector=injector, device="cpu")
    tr.params = lm_params_from_numpy(init, run.model, device="cpu")
    tr.opt_state = tr.opt.init(tr.params)
    tr._init_params = _clone(tr.params)
    tr._init_opt_state = _clone(tr.opt_state)
    return tr


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _close_after_steps(got, want, what):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    tight = 1e-5 + 1e-4 * np.abs(w)
    diff = np.abs(g - w)
    assert (diff <= tight).mean() >= 0.999, f"{what}: {(diff > tight).mean()}"
    assert (diff <= STEPS * 2 * LR).all(), f"{what}: max {diff.max()}"


def test_trainer_with_failure_equals_reference(reference, tmp_path):
    tr = _port(tmp_path, reference["init"],
               injector=failures.FailureInjector({FAIL_AT: "node_loss"}))
    # the sealed data path: the same session key, the same batches
    assert np.array_equal(tr._data_key.key.view(np.uint32),
                          reference["key"].view(np.uint32))
    for k, v in tr._sealed_batch(1).items():
        assert np.array_equal(v.numpy(), reference["batch"][k])
    out = tr.train()
    want = reference["out"]
    assert (out["final_step"], out["restarts"], out["replayed_steps"]) == (
        want["final_step"], want["restarts"], want["replayed_steps"]) == (
        STEPS, 1, FAIL_AT - CKPT_EVERY)
    assert [h["step"] for h in out["history"]] == \
        [h["step"] for h in want["history"]] == [1, 2, 3, 3, 4, 5, 6]
    for h, jh in zip(out["history"], want["history"]):
        assert abs(h["loss"] - jh["loss"]) <= 1e-5 * abs(jh["loss"])
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    flat = jax.tree_util.tree_flatten_with_path(reference["final"])[0]
    for (path, w), g in zip(flat, tree_leaves(tr.params)):
        _close_after_steps(g, w, jax.tree_util.keystr(path))


def test_sealed_batch_ciphertext_equals_reference(reference):
    """A batch sealed under the trainer's data key: the same words and
    tags as the reference's ``ingress`` (the key crosses as its words)."""
    from repro.crypto.keys import StageKey as JStageKey
    from repro_torch.crypto.keys import StageKey
    toks = data_fn(2)["tokens"]
    jkey = JStageKey(key=jnp.asarray(reference["key"]), stage_id=0)
    key = StageKey(key=reference["key"].view(np.int32), stage_id=0)
    jc = j_ingress("encrypted", jkey, 2 * 16 + 1, jnp.asarray(toks))
    c = ingress("encrypted", key, 2 * 16 + 1, torch.from_numpy(toks))
    assert np.array_equal(c.blocks.numpy().view(np.uint32),
                          np.asarray(jc.blocks))
    assert np.array_equal(c.tag.numpy().view(np.uint32), np.asarray(jc.tag))


def test_failure_before_first_checkpoint_equals_uninterrupted(tmp_path):
    """No checkpoint on disk at the failure: the trainer rewinds params
    AND optimizer state to its step-0 snapshot, and the recovered run
    equals the uninterrupted one bit for bit (bf16, port only)."""
    _, run = _runs()
    tc = dict(TCFG, total_steps=5, ckpt_every=8)

    def go(name, injector):
        tr = Trainer(run, data_fn, TrainerConfig(
            ckpt_dir=str(tmp_path / name), **tc), injector=injector,
            device="cpu")
        return tr, tr.train()
    ref_tr, ref_out = go("ref", None)
    tr, out = go("ck", failures.FailureInjector({3: "node_loss"}))
    assert ref_out["restarts"] == 0
    assert (out["restarts"], out["replayed_steps"], out["final_step"]) == \
        (1, 3, 5)
    assert out["history"][-1]["loss"] == ref_out["history"][-1]["loss"]
    for a, b in zip(tree_leaves(tr.params) + tree_leaves(tr.opt_state),
                    tree_leaves(ref_tr.params) +
                    tree_leaves(ref_tr.opt_state)):
        assert torch.equal(a, b)
    # the snapshot is a copy: it still holds the initial parameters
    assert not torch.equal(tr._init_params["embed"], tr.params["embed"])


def test_port_resumes_a_reference_checkpoint(reference, tmp_path):
    """The reference's sealed step-2 checkpoint, restored by the port's
    Trainer bit for bit, continues to the reference's losses."""
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    shutil.copytree(reference["ckdir"] / "step-00000002",
                    ckdir / "step-00000002")
    tr = _port(tmp_path, reference["init"], ckdir=ckdir)
    assert tr.restore() == CKPT_EVERY
    _, jparams, jopt = j_ckpt.restore(str(ckdir), CKPT_EVERY, seed=3,
                                      params_like=reference["init"],
                                      opt_like={"m": reference["init"],
                                                "v": reference["init"]})
    for got, want in zip(tree_leaves(tr.params) + tree_leaves(tr.opt_state),
                         jax.tree.leaves(jparams) + jax.tree.leaves(jopt)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    out = tr.train()
    assert (out["final_step"], out["restarts"]) == (STEPS, 0)
    want = reference["out"]["history"][3:]            # steps 3 (replayed) .. 6
    assert [h["step"] for h in out["history"]] == [h["step"] for h in want]
    for h, jh in zip(out["history"], want):
        assert abs(h["loss"] - jh["loss"]) <= 1e-5 * abs(jh["loss"])


def _recovery(pkg, directory_cls, kind, resume_past=False):
    """run_with_recovery of one package over a fake run with a failure of
    ``kind`` at step 3 and checkpoints every 2: -> (report fields,
    revoked ids, reestablish calls, restored-to steps)."""
    d = directory_cls(seed=1)
    for w in ("io/src", "w0", "w1"):
        d.enroll(w, b"m" * 32, allow=True)
    inj = pkg.FailureInjector({3: kind})
    state = {"ckpt": 0, "restores": [], "re": 0}

    def run_steps(start, end):
        for s in range(start, end):
            inj.maybe_fail(s)
            if (s + 1) % 2 == 0:
                state["ckpt"] = s + 1
        return end

    def restore():
        step = 6 if resume_past and state["restores"] else state["ckpt"]
        state["restores"].append(step)
        return step

    def reestablish(directory):
        assert directory is d
        state["re"] += 1
    rep = pkg.run_with_recovery(total_steps=8, run_steps=run_steps,
                                restore=restore, directory=d,
                                reestablish=reestablish)
    return ((rep.restarts, rep.failures, rep.replayed_steps,
             rep.final_step, rep.revoked_workers),
            sorted(d.policy.revoked), state["re"], state["restores"])


@pytest.mark.parametrize("kind", ["node_loss", "revoked:w1",
                                  "revoked:nobody"])
def test_run_with_recovery_revocation_equals_reference(kind):
    got = _recovery(failures, KeyDirectory, kind)
    want = _recovery(j_failures, JKeyDirectory, kind)
    assert got == want
    report, revoked, re, restores = got
    assert restores == [0, 2] and report[2] == 1 and report[3] == 8
    if kind == "revoked:w1":
        assert revoked == ["w1"] and report[4] == ["w1"] and re == 1
    else:
        assert report[4] == [] and re == 0


def test_run_with_recovery_refuses_a_restore_past_the_failure():
    for pkg, cls in ((failures, KeyDirectory), (j_failures, JKeyDirectory)):
        with pytest.raises(RuntimeError, match="past the failure"):
            _recovery(pkg, cls, "node_loss", resume_past=True)
