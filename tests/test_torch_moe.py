"""The port's MoE FFN (``models/moe.py``) against the JAX reference's
(``repro/models/moe.py``, its ``shard_map`` body on a one-device mesh of
Auto axes) on the CPU.

Weights are the reference's (``moe_template`` drawn by its init, the f32
router kept f32), inputs made from a seed with numpy.  ``moe_ffn``'s
output and aux loss in f32 and bf16, at the smoke config's capacity
factor (and, in ``tests/test_torch_moe_overflow.py``, at one that
overflows: tokens dropped at the trash row).
Tolerances: the combine rounds to bf16 on both sides (the reference's
bf16 ``psum``), so in f32 an element may round one bf16 ulp apart
(within 2^-8·|want| + 1e-6), and at most 1 % of the elements may; bf16
within 3e-2 + 2^-6·|want|; the aux loss (f32 both) within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as j_get_model_config
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.dist.meshctx import MeshContext
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers, moe
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture(scope="module")
def ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return MeshContext(mesh=mesh, rules=JShardingConfig().lookup())


def _cfgs(cf):
    jcfg = j_reduce_for_smoke(j_get_model_config(ARCH))
    cfg = reduce_for_smoke(get_model_config(ARCH))
    jm, m = jcfg.moe, cfg.moe
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
        jm, capacity_factor=cf)),
        dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=cf)))


def _weights(jcfg, dtype, seed=0):
    jp = j_layers.init_from_template(j_moe.moe_template(jcfg),
                                     jax.random.key(seed))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else getattr(torch, dtype))
        for k, v in jp.items()}
    return jp, p


@pytest.mark.parametrize("tokens,k,X,cf", [(64, 2, 8, 1.25), (1, 2, 8, 1.25),
                                           (8192, 6, 64, 1.25),
                                           (8192, 6, 64, 64 / 6),
                                           (100, 8, 384, 0.5)])
def test_capacity_equals_reference(tokens, k, X, cf):
    assert moe._capacity(tokens, k, X, cf) == j_moe._capacity(tokens, k, X,
                                                               cf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25])
def test_moe_ffn_equals_reference(ctx, cf, dtype):
    """At the smoke config's capacity factor (cf 0.25, where experts
    overflow: ``tests/test_torch_moe_overflow.py``)."""
    check_moe_ffn(ctx, cf, dtype)


def check_moe_ffn(ctx, cf, dtype):
    """``moe_ffn``'s output and aux loss against the reference's, and the
    capacity rule: every assignment kept at cf 1.25, some dropped (at the
    trash row) below it."""
    jcfg, cfg = _cfgs(cf)
    jp, p = _weights(jcfg, dtype)
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(
        np.float32)
    jo, jaux = j_moe.moe_ffn(jp, jnp.asarray(x, getattr(jnp, dtype)), jcfg,
                             ctx)
    o, aux = moe.moe_ffn(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                         cfg)
    assert o.dtype == getattr(torch, dtype) and o.shape == (2, 32, 64)
    got, want = o.float().numpy(), np.asarray(jo, np.float32)
    if dtype == "float32":
        off = np.abs(got - want) > 2e-5 + 1e-5 * np.abs(want)
        assert off.mean() <= 0.01
        assert (np.abs(got - want) <= 2 ** -8 * np.abs(want) + 1e-6).all()
    else:
        assert (np.abs(got - want) <= 3e-2 + 2 ** -6 * np.abs(want)).all()
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # the capacity rule: with cf 0.25 some assignments are dropped
    T, kk, X = 64, cfg.moe.top_k, cfg.moe.num_experts
    C = moe._capacity(T, kk, X, cf)
    _, _, topi = moe.route(p["router"], torch.from_numpy(x).reshape(T, 64)
                           .to(getattr(torch, dtype)), kk)
    _, keep, dest = moe.dispatch(topi, X, C)
    assert bool(keep.all()) == (cf == 1.25)
    assert int((dest == X * C).sum()) == int((~keep).sum())


def test_route_breaks_ties_to_the_lower_expert_like_top_k():
    """Equal probabilities (an all-zero router): jax.lax.top_k takes the
    lower index first, and so does the port."""
    router = torch.zeros((4, 8))
    x = torch.randn(5, 4)
    probs, topw, topi = moe.route(router, x, 3)
    jw, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.array_equal(topi.numpy(), np.asarray(ji))
    assert torch.equal(topi, torch.tensor([[0, 1, 2]] * 5))
    assert torch.allclose(topw, torch.full((5, 3), 1 / 3))


def test_moe_config_equals_reference():
    assert dataclasses.asdict(MoEConfig(4, 2, 16)) == dataclasses.asdict(
        JMoEConfig(4, 2, 16))
    spec = moe.moe_template(reduce_for_smoke(get_model_config(ARCH)))
    assert spec["router"].dtype == "float32"
    assert isinstance(spec["wg"], layers.ParamSpec)
