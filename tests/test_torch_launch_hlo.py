"""The op-level analyzer's FLOPs (``repro_torch.launch.analysis``, the
port's dry run of a step on meta tensors) against the reference's
``repro.launch.hloanalysis.analyze`` of the compiled HLO of the same step,
for llama3.2-1b's smoke config at 2 x 256 tokens: train (remat "none"
and "full"), prefill and decode.

Both count matrix products only (dots; aten ``mm``/``bmm`` and kernels
7's and 8's operators).  The known differences, each checked:

* masked causal blocks: the reference's flash attention computes the
  whole (S, S) square at S = 256 (one block, its chunk is 512) and masks
  it, forward and backward; kernel 7 computes, and its FLOP formula
  counts, the causal pairs only (``ops.flops``), and so does kernel 8,
  the backward (``ops.backward_flops``, 2.5 times the forward's: five
  products to the forward's two).  Adding the masked part, L *
  (flops(causal=False) - flops(causal=True)) a forward pass and 2.5 times
  that a backward, makes prefill and the remat "none" train step equal
  exactly.
* remat "full": XLA's and the port's recompute differ (the port's
  non-reentrant ``torch.utils.checkpoint`` stops recomputing once the
  saved tensors it needs are back, so the LM head's chunks are not
  recomputed; the reference recomputes its attention forward).  With the
  backward's masked part added, the port counts at most 10 % fewer
  there.
* decode: the same products, exactly.

The reference's steps are jitted on a ``MeshContext`` built on Auto axes
(the Explicit-axes fault of ROADMAP Queue 3)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_model_config as j_get_model_config
from repro.configs import get_run_config as j_get_run_config
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.dist.meshctx import MeshContext
from repro.launch.hloanalysis import analyze as hlo_analyze
from repro.models import api as japi
from repro.serve.engine import make_decode_step as j_make_decode_step
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_model_config, get_run_config
from repro_torch.configs import reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import dryrun
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "llama3.2-1b"
B, S = 2, 256
#: remat "full": the port's count over the reference's, at least
REMAT_FULL_MIN_RATIO = 0.9


@pytest.fixture(scope="module")
def ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return MeshContext(mesh=mesh, rules=JShardingConfig().lookup())


def _reference_flops(ctx, kind, remat):
    cfg = j_reduce_for_smoke(j_get_model_config(ARCH))
    run = dataclasses.replace(j_get_run_config(ARCH, "train_4k"), model=cfg,
                              shape=JShapeConfig("smoke", S, B, kind),
                              remat=remat)
    p = japi.abstract_params(cfg)
    i32 = jnp.int32
    tokens = jax.ShapeDtypeStruct((B, S), i32)
    if kind == "train":
        step, opt = j_make_train_step(run, ctx)
        lowered = jax.jit(step).lower(
            p, jax.eval_shape(opt.init, p), {"tokens": tokens,
                                             "labels": tokens},
            jax.ShapeDtypeStruct((), i32))
    elif kind == "prefill":
        lowered = jax.jit(j_make_prefill_step(run, ctx, max_seq=S)).lower(
            p, {"tokens": tokens})
    else:
        lowered = jax.jit(j_make_decode_step(run, ctx)).lower(
            p, jax.ShapeDtypeStruct((B, 1), i32),
            jax.ShapeDtypeStruct((), i32), japi.abstract_cache(cfg, B, S))
    return hlo_analyze(lowered.compile().as_text()).flops


#: the masked part's weight in a step: the forward's once, and in training
#: the backward's 2.5 times more
MASKED_WEIGHT = {"prefill": 1.0, "train": 3.5}


def _port(kind, remat):
    cfg = reduce_for_smoke(get_model_config(ARCH))
    run = dataclasses.replace(get_run_config(ARCH, "train_4k"), model=cfg,
                              shape=ShapeConfig("smoke", S, B, kind),
                              remat=remat)
    an, _ = dryrun.trace_cell(run)
    masked = cfg.num_layers * (
        ops.flops(B, cfg.num_heads, S, S, cfg.head_dim, False)
        - ops.flops(B, cfg.num_heads, S, S, cfg.head_dim, True))
    return an, masked


@pytest.mark.parametrize("kind,remat", [("train", "none"),
                                        ("prefill", "full")])
def test_counted_flops_equal_the_hlo_plus_the_masked_blocks(ctx, kind,
                                                            remat):
    an, masked = _port(kind, remat)
    assert an.flops_by_op["repro_torch.flash_attention_fwd"] > 0
    assert ("repro_torch.flash_attention_bwd" in an.flops_by_op) == (
        kind == "train")
    assert an.flops + MASKED_WEIGHT[kind] * masked == _reference_flops(
        ctx, kind, remat)


def test_counted_flops_of_a_remat_full_train_step(ctx):
    an, masked = _port("train", "full")
    want = _reference_flops(ctx, "train", "full")
    # kernel 8's masked part (the reference's backward computes it) added
    bwd_masked = (MASKED_WEIGHT["train"] - 1) * masked
    assert REMAT_FULL_MIN_RATIO * want <= an.flops + bwd_masked <= want
    assert an.flops + bwd_masked + 2 * masked > want   # kernel 7 runs twice


def test_counted_flops_of_a_decode_step_equal_the_hlo(ctx):
    an, _ = _port("decode", "full")
    assert "repro_torch.flash_attention_fwd" not in an.flops_by_op
    assert an.flops == _reference_flops(ctx, "decode", "full")
