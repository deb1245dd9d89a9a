"""The port's distribution layer (``repro_torch.dist``) against the
reference's ``repro.dist`` on the CPU: ``MeshContext.spec_for`` over the
production mesh shapes (as ``AbstractMesh``, no devices) and the smoke
shapes for a seeded grid of dims under the default ``ShardingConfig``
rules and ``with_rule`` variants, ``strict`` and ``allow_uneven``;
``gpipe_schedule``; ``pipeline_apply`` for S in {1, 2, 4}, sealed and
not, with ``rekey_every_n``, and its ``PipelineMACError`` on a tampered
hand-off; and the router's ``shuffle_by_key`` with and without a mask,
duplicate keys included.  A single-op stage (``x * w``) must match bit
for bit; a matmul stage (``tanh(x @ w)``, f32) within rtol 1e-5, atol
1e-6, since the two packages' CPU matmuls may sum in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ShardingConfig as JShardingConfig
from repro.core.router import shuffle_by_key as j_shuffle_by_key
from repro.dist import pipeline_parallel as jpp
from repro.dist.meshctx import MeshContext as JMeshContext
from repro_torch.configs.base import ShardingConfig
from repro_torch.core.router import RouterPolicy, shuffle_by_key
from repro_torch.dist import pipeline_parallel as pp
from repro_torch.dist.meshctx import (MeshContext, local_mesh_context,
                                      make_mesh, make_smoke_mesh)
from repro_torch.obs.metrics import REGISTRY

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _fresh_port_state():
    """The port's REGISTRY and its cached default directories' audit logs
    (``tests/conftest.py`` resets only the reference's)."""
    REGISTRY.reset()
    for d in pp._DEFAULT_DIRS.values():
        d.audit.clear()
    yield


# ------------------------------------------------------------- spec_for

MESHES = {"pod_data_model": ((2, 16, 16), ("pod", "data", "model")),
          "data_model": ((16, 16), ("data", "model")),
          "smoke_1x1": ((1, 1), ("data", "model")),
          "smoke_4x2": ((4, 2), ("data", "model"))}
RULES = {
    "default": lambda c: c,
    "batch_all": lambda c: c.with_rule("batch", ("pod", "data", "model")),
    "seq_model": lambda c: c.with_rule("seq", ("model",)),
    "embed_data": lambda c: c.with_rule("embed", ("data", "pod")),
    "heads_twice": lambda c: c.with_rule("heads", ("model", "model",
                                                   "data")),
    "mlp_missing": lambda c: c.with_rule("mlp", ("expert", "model")),
}
NAMES = [None, "batch", "seq", "seq_res", "embed", "vocab", "heads",
         "kv_heads", "mlp", "experts", "kv_seq", "zero", "unknown"]
DIMS = [1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 256, 512, 1000, 4096]


def _grid(seed, n=120):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        rank = int(rng.integers(1, 5))
        yield ([NAMES[i] for i in rng.integers(0, len(NAMES), rank)],
               [DIMS[i] for i in rng.integers(0, len(DIMS), rank)])


@pytest.mark.parametrize("uneven", [True, False])
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_equals_reference(mesh, rules, uneven):
    shape, axes = MESHES[mesh]
    cfg, jcfg = RULES[rules](ShardingConfig()), RULES[rules](JShardingConfig())
    assert cfg.rules == jcfg.rules and cfg.lookup() == jcfg.lookup()
    ctx = MeshContext(mesh=make_mesh(shape, axes, device=CPU),
                      rules=cfg.lookup(), allow_uneven=uneven)
    jctx = JMeshContext(mesh=AbstractMesh(shape, axes), rules=jcfg.lookup(),
                        allow_uneven=uneven)
    assert ctx.dp_axes == jctx.dp_axes
    for a in axes + ("expert",):
        assert ctx.axis_size(a) == jctx.axis_size(a)
    seed = sorted(MESHES).index(mesh) * 100 + sorted(RULES).index(rules)
    for dims, dim_sizes in _grid(seed):
        for strict in (False, True):
            got = ctx.spec_for(dims, dim_sizes, strict=strict)
            want = tuple(jctx.spec_for(dims, dim_sizes, strict=strict))
            assert got == want, (dims, dim_sizes, strict)


def test_mesh_helpers_and_constrain():
    m = make_smoke_mesh(4, device=CPU)
    assert m.shape == {"data": 2, "model": 2}
    assert m.axis_names == ("data", "model")
    assert make_smoke_mesh(3, device=CPU).shape == {"data": 3, "model": 1}
    ctx = local_mesh_context(device=CPU)
    assert ctx.mesh.shape == {"data": 1, "model": 1}
    assert ctx.rules == JShardingConfig().lookup()
    x = torch.zeros(4, 8)
    assert ctx.constrain(x, ("batch", "embed")) is x
    with pytest.raises(ValueError):
        ctx.constrain(x.to(torch.float64).to("meta"), ("batch", "embed"))
    with pytest.raises(ValueError):
        ctx.spec_for(("batch",), (4, 8))
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "data"), device=CPU)
    assert RouterPolicy("keyed", 8).num_keys == 8


# ------------------------------------------------------------ the schedule


@pytest.mark.parametrize("S,M", [(1, 1), (1, 4), (3, 5), (4, 2), (5, 8)])
def test_gpipe_schedule_equals_reference(S, M):
    assert pp.gpipe_schedule(S, M) == jpp.gpipe_schedule(S, M)


def _stage_inputs(S, M, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((S, 8, 8)).astype(np.float32)
    xs = rng.standard_normal((M, 2, 8)).astype(np.float32)
    return w, xs


def _scale(w, x):
    return x * w[0]


def _j_tanh(w, x):
    return jnp.tanh(x @ w)


def _tanh(w, x):
    return torch.tanh(x @ w)


def _both(S, M, *, seal, fn=(_scale, _scale), **kw):
    w, xs = _stage_inputs(S, M)
    jkw, tkw = dict(kw), dict(kw)
    if "rekey_every_n" in kw:
        jkw["directory"] = jpp.edge_directory(S, seed=4)
        tkw["directory"] = pp.edge_directory(S, seed=4)
    want = np.asarray(jpp.pipeline_apply(fn[0], jnp.asarray(w),
                                         jnp.asarray(xs), None, seal=seal,
                                         **jkw))
    got = pp.pipeline_apply(fn[1], torch.from_numpy(w), torch.from_numpy(xs),
                            None, seal=seal, **tkw).numpy()
    return got, want, w, xs


@pytest.mark.parametrize("seal", [False, True])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_pipeline_apply_equals_reference_bit_for_bit(S, seal):
    got, want, w, xs = _both(S, 3, seal=seal)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    chain = xs.copy()
    for s in range(S):
        chain = chain * w[s, 0]
    assert np.array_equal(got.view(np.uint32), chain.view(np.uint32))


@pytest.mark.parametrize("seal", [False, True])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_pipeline_apply_with_a_matmul_stage_equals_reference(S, seal):
    got, want, _, _ = _both(S, 3, seal=seal, fn=(_j_tanh, _tanh))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rekey", [1, 2])
def test_pipeline_apply_rekeyed_equals_reference(rekey):
    got, want, _, _ = _both(4, 3, seal=True, rekey_every_n=rekey)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_pipeline_apply_rekey_drains_under_the_sealing_epoch():
    """Every hand-off opens under its sealing epoch across the flips:
    the rekeyed run equals the static one, and the directory advanced."""
    w, xs = _stage_inputs(4, 5)
    d = pp.edge_directory(4, seed=4)
    static = pp.pipeline_apply(_scale, torch.from_numpy(w),
                               torch.from_numpy(xs), seal=True, key_seed=4)
    rekeyed = pp.pipeline_apply(_scale, torch.from_numpy(w),
                                torch.from_numpy(xs), seal=True, directory=d,
                                rekey_every_n=2)
    assert torch.equal(static, rekeyed)
    assert d.epoch == (5 + 4 - 1) // 2


def _tamper(mod, monkeypatch, targets):
    """Wrap ``mod.unprotect_many`` so each hand-off into a (stage, mb) of
    ``targets`` has one ciphertext word flipped (the wire is tampered)."""
    real = mod.unprotect_many

    def wrapped(keys, steps, cts, tags, meta):
        for i, (k, st) in enumerate(zip(keys, steps)):
            if (int(k.stage_id), st) in targets:
                if isinstance(cts, torch.Tensor):
                    cts = cts.clone()
                    cts[i, 0] ^= 1
                else:
                    cts = cts.at[i, 0].set(cts[i, 0] ^ 1)
        return real(keys, steps, cts, tags, meta)
    monkeypatch.setattr(mod, "unprotect_many", wrapped)


# (stage, microbatch) hand-offs to tamper, and the one the error names:
# the first failing item of its tick's group, as the reference checks them
TAMPERS = [([(1, 0)], (1, 0)), ([(3, 2)], (3, 2)), ([(2, 1)], (2, 1)),
           ([(2, 1), (1, 2)], (1, 2)), ([(3, 1), (2, 2)], (2, 2))]


@pytest.mark.parametrize("targets,named", TAMPERS)
def test_pipeline_apply_raises_on_a_tampered_hand_off(monkeypatch, targets,
                                                      named):
    w, xs = _stage_inputs(4, 3)
    _tamper(jpp, monkeypatch, targets)
    _tamper(pp, monkeypatch, targets)
    with pytest.raises(jpp.PipelineMACError) as jerr:
        jpp.pipeline_apply(_scale, jnp.asarray(w), jnp.asarray(xs), None)
    with pytest.raises(pp.PipelineMACError) as err:
        pp.pipeline_apply(_scale, torch.from_numpy(w), torch.from_numpy(xs))
    assert str(err.value) == str(jerr.value) == \
        f"MAC failure on edge into stage {named[0]}, microbatch {named[1]}"


def test_pipeline_apply_checks_the_mesh_axis_and_the_shared_directory():
    w, xs = torch.zeros((2, 4, 4)), torch.zeros((3, 2, 4))
    pp.pipeline_apply(lambda a, x: x @ a, w, xs,
                      make_mesh((1,), ("stage",), device=CPU))
    pp.pipeline_apply(lambda a, x: x @ a, w, xs,
                      make_mesh((2,), ("stage",), device=CPU))
    with pytest.raises(ValueError, match="size 3 but there are 2 stages"):
        pp.pipeline_apply(lambda a, x: x @ a, w, xs,
                          make_mesh((3,), ("stage",), device=CPU))
    with pytest.raises(ValueError, match="explicit directory"):
        pp.pipeline_apply(lambda a, x: x @ a, w, xs, rekey_every_n=2)


# ---------------------------------------------------------- shuffle_by_key


CASES = [(n, k, seed) for seed, (n, k) in enumerate(
    [(2, 1), (8, 3), (17, 4), (64, 8), (33, 1), (40, 40), (5, 9), (64, 2)])]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,num_keys,seed", CASES)
def test_shuffle_by_key_equals_reference(n, num_keys, seed, masked):
    rng = np.random.default_rng(seed)
    # few distinct keys: duplicates in every bucket with more rows than keys
    keys = rng.integers(0, num_keys, n).astype(np.int32)
    x = rng.integers(-2 ** 31, 2 ** 31, (n, 3), dtype=np.int64) \
        .astype(np.int32)
    mask = rng.random(n) < 0.6 if masked else None
    jb, jc = j_shuffle_by_key(jnp.asarray(x), jnp.asarray(keys), num_keys,
                              None if mask is None else jnp.asarray(mask))
    b, c = shuffle_by_key(torch.from_numpy(x), torch.from_numpy(keys),
                          num_keys,
                          None if mask is None else torch.from_numpy(mask))
    assert np.array_equal(b.numpy(), np.asarray(jb))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert c.dtype == torch.int32


def test_shuffle_by_key_keeps_input_order_within_a_bucket():
    """The stable sort: equal keys keep their input order (an unstable
    sort would permute rows within a bucket)."""
    keys = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int32)
    x = torch.arange(6, dtype=torch.float32)[:, None]
    b, c = shuffle_by_key(x, keys, 2)
    assert c.tolist() == [2, 4]
    assert b[0, :2, 0].tolist() == [1.0, 4.0]
    assert b[1, :4, 0].tolist() == [0.0, 2.0, 3.0, 5.0]
