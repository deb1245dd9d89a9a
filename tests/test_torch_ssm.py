"""The port's recurrent blocks against the JAX reference's on the CPU:
Mamba2 (``models/mamba2.py``: forward, forward with its decode cache, and
the decode step that continues from it) here, and xLSTM's mLSTM and
sLSTM (``models/xlstm.py``: the same three each) in
``tests/test_torch_ssm_xlstm.py``, at the smoke configs' widths, in f32
and bf16.

Weights are layer 0 of the reference's smoke model (f32 leaves stay f32;
Mamba2's ``A_log`` and ``dt_bias`` get values from a seed), inputs from a
seed with numpy.  Tolerances as ``tests/test_torch_lm.py``: f32 within
2e-5 + 1e-5·|want|, bf16 within 3e-2 + 2^-6·|want|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as j_get_model_config
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.dist.meshctx import MeshContext
from repro.models import api as j_api
from repro.models import mamba2 as j_m2
from repro.models import xlstm as j_xl
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.models import mamba2 as m2
from repro_torch.models import xlstm as xl
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 32


@pytest.fixture(scope="module")
def ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return MeshContext(mesh=mesh, rules=JShardingConfig().lookup())


def _close(got, want, dtype):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], dtype)
        return
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol, rtol = (2e-5, 1e-5) if dtype == "float32" else (3e-2, 2 ** -6)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, f"max excess {excess.max()} ({dtype})"


def _block(arch, key, dtype, seed=0):
    """(reference cfg, its layer-0 params of ``key``, port cfg, port's)."""
    jcfg = j_reduce_for_smoke(j_get_model_config(arch))
    cfg = reduce_for_smoke(get_model_config(arch))
    jp = jax.tree.map(lambda a: a[0], j_api.init_params(
        jcfg, jax.random.key(seed))["layers"][key])
    rng = np.random.default_rng(seed + 1)
    for name in ("A_log", "dt_bias"):
        if name in jp:
            jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * 0.5,
                                   jnp.float32)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in jp.items()}
    return jcfg, jp, cfg, p


def _x(dtype, seed, s=S):
    a = np.random.default_rng(seed).standard_normal((B, s, 64)).astype(
        np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


def _port_tree(tree):
    return {k: torch.from_numpy(np.array(jnp.asarray(v).astype(
        jnp.float32))).to(torch.float32 if v.dtype == jnp.float32
                          else torch.bfloat16) for k, v in tree.items()}


CASES = [("zamba2-1.2b", "mamba", j_m2.mamba2_forward,
          j_m2.mamba2_forward_with_state, j_m2.mamba2_decode,
          m2.mamba2_forward, m2.mamba2_forward_with_state, m2.mamba2_decode)]
#: xLSTM's blocks: tests/test_torch_ssm_xlstm.py
XLSTM_CASES = [("xlstm-125m", "mlstm", j_xl.mlstm_forward,
          j_xl.mlstm_forward_with_state, j_xl.mlstm_decode,
          xl.mlstm_forward, xl.mlstm_forward_with_state, xl.mlstm_decode),
         ("xlstm-125m", "slstm", j_xl.slstm_forward,
          j_xl.slstm_forward_with_state, j_xl.slstm_decode,
          xl.slstm_forward, xl.slstm_forward_with_state, xl.slstm_decode)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[1] for c in CASES])
def test_block_forward_state_and_decode_equal_reference(ctx, case, dtype):
    check_block(ctx, case, dtype)


def check_block(ctx, case, dtype):
    """Forward, forward with its state, and one decode step from the
    reference's own state, against the reference's."""
    arch, key, jf, jfs, jdec, f, fs, dec = case
    jcfg, jp, cfg, p = _block(arch, key, dtype)
    jx, x = _x(dtype, seed=2)
    _close(f(p, x, cfg), jf(jp, jx, jcfg, ctx), dtype)
    jy, jst = jfs(jp, jx, jcfg, ctx)
    y, st = fs(p, x, cfg)
    _close(y, jy, dtype)
    _close(st, jst, dtype)
    # one decode step from the reference's own state, for both
    jt, t = _x(dtype, seed=3, s=1)
    jy, jst2 = jdec(jp, jt, jst, jcfg, ctx)
    y, st2 = dec(p, t, _port_tree(jst), cfg)
    _close(y, jy, dtype)
    _close(st2, jst2, dtype)


@pytest.mark.parametrize("key", ["mamba"])
def test_decode_continues_the_forward(key):
    check_decode_continues(key)


def check_decode_continues(key):
    """Prefill over S then one decode step equals the forward over S + 16
    at position S (f32): the carried conv inputs and SSM state are the
    whole past."""
    arch = "zamba2-1.2b" if key == "mamba" else "xlstm-125m"
    fs, dec, f = ((m2.mamba2_forward_with_state, m2.mamba2_decode,
                   m2.mamba2_forward) if key == "mamba" else
                  (xl.mlstm_forward_with_state, xl.mlstm_decode,
                   xl.mlstm_forward))
    _, _, cfg, p = _block(arch, key, "float32", seed=4)
    _, x = _x("float32", seed=5, s=S + 16)
    _, st = fs(p, x[:, :S], cfg)
    y, _ = dec(p, x[:, S:S + 1], st, cfg)
    whole = f(p, x, cfg)
    _close(y[:, 0], whole[:, S].numpy(), "float32")
