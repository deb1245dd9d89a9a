"""The port's train step for the vlm and audio families (internvl2-76b
and musicgen-large at their ``reduce_for_smoke`` forms) against the JAX
reference on the CPU: two AdamW steps each and, for the audio model, a
step of two microbatches, in f32 (their gradients and bf16 steps are in
``tests/test_torch_train_families_frontends.py``); and the port's
``Trainer`` on the audio, MoE and ssm smoke models, sealed data (float
frames beside the tokens) and sealed checkpoints, recovered from a
failure bit for bit.  The reference checks and their tolerances are in
``tests/_torch_train_families.py``."""
import numpy as np
import pytest
import torch

from _torch_families import make_ctx
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import check_microbatches, check_steps
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.ft.failures import FailureInjector
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = ["internvl2-76b", "musicgen-large"]


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_adamw_steps_equal_reference(ctx, arch):
    check_steps(ctx, arch)


def test_audio_microbatches_equal_reference(ctx):
    check_microbatches(ctx, "musicgen-large")


def _family_data_fn(cfg):
    """Seeded batches of 2 x 32: tokens and labels, with (float32) frames
    for the audio front end."""
    def data_fn(step):
        rng = np.random.default_rng(500 + step)
        toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if cfg.frontend == "audio_frames":
            out["frames"] = rng.standard_normal(
                (2, 32, cfg.frontend_dim)).astype(np.float32)
        return out
    return data_fn


@pytest.mark.parametrize("arch", ["musicgen-large", "moonshot-v1-16b-a3b",
                                  "xlstm-125m"])
def test_trainer_recovers_a_family_bit_for_bit(tmp_path, arch):
    """The port's ``Trainer`` on a non-dense family's smoke form, sealed
    batches (the audio model's float32 frames sealed and opened beside its
    tokens and labels) and sealed checkpoints every 2 steps: a failure at
    step 3 restores step 2, and the recovered run's parameters and
    optimizer state equal an uninterrupted run's bit for bit (port only,
    bf16)."""
    cfg = reduce_for_smoke(get_model_config(arch))
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                    optimizer=OptimizerConfig(lr=5e-3, warmup_steps=2))
    data_fn = _family_data_fn(cfg)

    def go(name, injector):
        tr = Trainer(run, data_fn, TrainerConfig(
            total_steps=5, ckpt_every=2, log_every=1,
            ckpt_dir=str(tmp_path / name)), injector=injector, device="cpu")
        return tr, tr.train()
    ref_tr, ref_out = go("plain", None)
    tr, out = go("ck", FailureInjector({3: "node_loss"}))
    assert (out["restarts"], out["replayed_steps"], out["final_step"]) == \
        (1, 1, 5)
    assert out["history"][-1]["loss"] == ref_out["history"][-1]["loss"]
    batch = tr._sealed_batch(1)
    assert set(batch) == set(data_fn(1))
    for k, v in data_fn(1).items():
        assert torch.equal(batch[k], torch.from_numpy(v))
    for a, b in zip(tree_leaves(tr.params) + tree_leaves(tr.opt_state),
                    tree_leaves(ref_tr.params) +
                    tree_leaves(ref_tr.opt_state)):
        assert torch.equal(a, b)
