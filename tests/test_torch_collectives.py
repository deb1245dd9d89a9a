"""The port's collectives (``repro_torch.dist.collectives``, the router's
``shuffle_sharded``/``route_keyed_sharded``) against the reference's on
the CPU, bit for bit.  At W = 1 in-process on an Auto-axes
``jax.make_mesh`` (the reference's Explicit-axes smoke mesh fails under
this jax, ROADMAP Queue 3): ``exchange``, ``secure_exchange`` under a raw
key with ``step`` and under a directory handle with managed counters,
``keyed_route`` plain and sealed, and the ``ValueError``s.  At W = 4
against ONE subprocess of the reference on four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, Auto axes),
which writes its outputs as ``.npz``: ``secure_exchange``,
``keyed_route`` plain and sealed, and ``sealed_ppermute`` under
``shard_map`` with one shard left without a sender.  The port runs the W
workers on one device (``make_mesh(..., device="cpu")``)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.attest.directory import ephemeral_edge_key as j_ephemeral_edge_key
from repro.attest.measure import IO_ENDPOINT as J_IO_ENDPOINT
from repro.dist import collectives as jcol
from repro_torch.attest.directory import KeyDirectory, ephemeral_edge_key
from repro_torch.attest.measure import IO_ENDPOINT
from repro_torch.core import router
from repro_torch.core.secure_channel import sealed_ppermute
from repro_torch.crypto import aead
from repro_torch.dist import collectives as col
from repro_torch.dist.meshctx import make_mesh
from repro_torch.obs.metrics import REGISTRY
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _fresh_port_registry():
    REGISTRY.reset()
    yield


def _mesh(W):
    return make_mesh((W,), ("model",), device=CPU)


def _jmesh():
    return jax.make_mesh((1,), ("model",), axis_types=(AxisType.Auto,))


def _inputs(W, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((W, W, 16, 4)).astype(np.float32),
        "rows": rng.integers(0, 2 ** 32, (W, 32, 4), dtype=np.uint32),
        "row_keys": rng.integers(-2 ** 31, 2 ** 31, (W, 32), dtype=np.int64)
        .astype(np.int32),
        "shards": rng.standard_normal((W, 6, 5)).astype(np.float32),
    }


def _t(a):
    """numpy -> torch on the CPU (uint32 through the int32 carrier)."""
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------------ W = 1


def test_exchange_and_secure_exchange_at_one_worker_equal_reference():
    x = _inputs(1)["x"]
    jkey, key = (j_ephemeral_edge_key("shuffle", seed=0),
                 ephemeral_edge_key("shuffle", seed=0))
    assert torch.equal(col.exchange(_t(x), _mesh(1)), _t(x).transpose(0, 1))
    jy, jok = jcol.secure_exchange(jnp.asarray(x), _jmesh(), "model",
                                   key=jkey, step=11)
    y, ok = col.secure_exchange(_t(x), _mesh(1), "model", key=key, step=11)
    assert ok.tolist() == np.asarray(jok).tolist() == [[True]]
    assert np.array_equal(_u32(y), np.asarray(jy).view(np.uint32))
    assert np.array_equal(y.numpy(), x.swapaxes(0, 1))


def _directories():
    jd, d = JKeyDirectory(seed=3), KeyDirectory(seed=3)
    for dd, endpoint in ((jd, J_IO_ENDPOINT), (d, IO_ENDPOINT)):
        dd.enroll("w/a", endpoint, allow=True)
        dd.enroll("w/b", endpoint, allow=True)
        dd.establish("shuffle", "w/a", "w/b", stage_id=0)
    return jd, d


def test_secure_exchange_with_a_directory_handle_equals_reference():
    """Managed counters: each round reserves W^2 counters from the edge,
    so two rounds differ and both packages' counters advance alike."""
    x = _inputs(1, seed=1)["x"]
    jd, d = _directories()
    jh, h = jd.handle("shuffle"), d.handle("shuffle")
    for _ in range(2):
        jy, jok = jcol.secure_exchange(jnp.asarray(x), _jmesh(), "model",
                                       key=jh)
        y, ok = col.secure_exchange(_t(x), _mesh(1), "model", key=h)
        assert bool(ok.all()) and bool(np.asarray(jok).all())
        assert np.array_equal(_u32(y), np.asarray(jy).view(np.uint32))
        assert h.next_counter() == jh.next_counter()


@pytest.mark.parametrize("sealed", [False, True])
def test_keyed_route_at_one_worker_equals_reference(sealed):
    inp = _inputs(1, seed=2)
    jkey, key = (j_ephemeral_edge_key("route", seed=1),
                 ephemeral_edge_key("route", seed=1)) if sealed else \
        (None, None)
    kw = dict(step=4) if sealed else {}
    ji, jc, jok = jcol.keyed_route(jnp.asarray(inp["rows"]),
                                   jnp.asarray(inp["row_keys"]), _jmesh(),
                                   "model", key=jkey, **kw)
    i, c, ok = router.route_keyed_sharded(_t(inp["rows"]),
                                          _t(inp["row_keys"]), _mesh(1),
                                          "model", key=key, **kw)
    assert np.array_equal(_u32(i), np.asarray(ji))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert ok.tolist() == np.asarray(jok).tolist()


def test_secure_exchange_spans_equal_reference():
    """Under a tracer, the sealed round opens the reference's spans: the
    ``dist.secure_exchange`` span around one nested ``dist.exchange``."""
    from repro.obs.trace import Tracer as JTracer
    from repro_torch.obs.trace import Tracer
    x = _inputs(1, seed=4)["x"]
    jt, t = JTracer(), Tracer()
    jcol.secure_exchange(jnp.asarray(x), _jmesh(), "model",
                         key=j_ephemeral_edge_key("shuffle", seed=0),
                         step=2, tracer=jt)
    col.secure_exchange(_t(x), _mesh(1), "model",
                        key=ephemeral_edge_key("shuffle", seed=0), step=2,
                        tracer=t)

    def shape(tr):
        return [(s.name, s.cat, s.track, s.parent, s.args)
                for s in tr.spans]
    assert shape(t) == shape(jt)
    assert [s.name for s in t.spans] == ["dist.secure_exchange",
                                         "dist.exchange"]


def test_collectives_refuse_what_the_reference_refuses():
    x = _t(_inputs(1)["x"])
    key = ephemeral_edge_key("shuffle", seed=0)
    h = _directories()[1].handle("shuffle")
    m = _mesh(1)
    with pytest.raises(ValueError):                 # not a 4-byte dtype
        col.secure_exchange(x.to(torch.bfloat16), m, "model", key=key,
                            step=0)
    with pytest.raises(ValueError):                 # not a mailbox
        col.secure_exchange(x[0], m, "model", key=key, step=0)
    with pytest.raises(ValueError, match="explicit per-round step"):
        col.secure_exchange(x, m, "model", key=key)
    with pytest.raises(ValueError, match="manages its own round counters"):
        col.secure_exchange(x, m, "model", key=h, step=3)
    with pytest.raises(ValueError):                 # keys do not match rows
        col.keyed_route(x[:, 0], torch.zeros((1, 5), dtype=torch.int32), m)
    with pytest.raises(ValueError):                 # no such axis
        col.exchange(x, m, "data")
    with pytest.raises(ValueError):                 # not on the mesh device
        col.exchange(x.to("meta"), m)


def test_one_exchange_per_sealed_round():
    inp = _inputs(1, seed=3)
    key = ephemeral_edge_key("count", seed=0)
    m = _mesh(1)
    n0 = col.exchange_call_count()
    site = REGISTRY.counter("device.dispatches.dist.exchange")
    s0 = site.value
    router.shuffle_sharded(_t(inp["x"]), m, key=key, step=0)
    assert col.exchange_call_count() == n0 + 1
    router.route_keyed_sharded(_t(inp["rows"]), _t(inp["row_keys"]), m,
                               key=key, step=1)
    assert col.exchange_call_count() == n0 + 2
    router.route_keyed_sharded(_t(inp["rows"]), _t(inp["row_keys"]), m)
    assert col.exchange_call_count() == n0 + 4      # blocks, then counts
    assert site.value == s0 + 4


def test_route_nonces_equal_reference_and_are_cached():
    a = col._route_nonces(4, 9, CPU)
    assert col._route_nonces(4, 9, CPU) is a        # cached, not rebuilt
    assert np.array_equal(a.numpy().view(np.uint32),
                          np.asarray(jcol._route_nonces(4, 9)))
    assert not torch.equal(a, col._route_nonces(4, 10, CPU))
    big = col._route_nonces_base(3, 2 ** 40 + 5, CPU)   # counter > 2^32
    assert np.array_equal(big.numpy().view(np.uint32), np.asarray(
        jcol._route_nonces_base(3, 2 ** 40 + 5)))
    for base in range(col._NONCE_CACHE_MAX):        # evicts the oldest
        col._route_nonces_base(2, 1000 + base, CPU)
    assert col._route_nonces(4, 9, CPU) is not a
    assert len(col._NONCE_CACHE) == col._NONCE_CACHE_MAX


def test_consistent_hash_matches_the_u32_reference():
    """The port lifts to int64 and masks before the shift: the int32
    carrier's sign would otherwise leak into ``>> 16``."""
    k = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345, -987654],
                 np.int32)
    want = np.asarray(jcol._consistent_hash(jnp.asarray(k)))
    assert np.array_equal(col._consistent_hash(torch.from_numpy(k)).numpy(),
                          want.astype(np.int64))


# ------------------------------------------------------------------ W = 4

_ORACLE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.attest.directory import ephemeral_edge_key
from repro.core.secure_channel import sealed_ppermute
from repro.dist.collectives import keyed_route, secure_exchange
from repro.dist.compat import shard_map

inp = dict(np.load(sys.argv[1]))
W = len(jax.devices())
assert W == 4, W
mesh = jax.make_mesh((W,), ("model",), axis_types=(AxisType.Auto,))
out = {}
y, ok = secure_exchange(jnp.asarray(inp["x"]), mesh, "model",
                        key=ephemeral_edge_key("shuffle", seed=0), step=11)
out["sx_y"], out["sx_ok"] = np.asarray(y), np.asarray(ok)
for name, key in (("plain", None),
                  ("sealed", ephemeral_edge_key("route", seed=1))):
    kw = dict(step=4) if key is not None else {}
    i, c, ok = keyed_route(jnp.asarray(inp["rows"]),
                           jnp.asarray(inp["row_keys"]), mesh, "model",
                           key=key, **kw)
    out[f"kr_{name}_inbox"], out[f"kr_{name}_counts"] = \
        np.asarray(i), np.asarray(c)
    out[f"kr_{name}_ok"] = np.asarray(ok)
perm = [(0, 1), (1, 3), (3, 0)]
key = ephemeral_edge_key("ring", seed=2)

def f(xb):
    y, ok = sealed_ppermute(key, 7, xb[0], "model", perm)
    return y[None], ok[None]

y, ok = shard_map(f, mesh=mesh, in_specs=P("model"),
                  out_specs=(P("model"), P("model")))(jnp.asarray(
                      inp["shards"]))
out["pp_y"], out["pp_ok"] = np.asarray(y), np.asarray(ok)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def four_workers(tmp_path_factory):
    """(inputs, the reference's outputs at W = 4 on four host devices)."""
    d = tmp_path_factory.mktemp("w4")
    inp = _inputs(4, seed=7)
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", _ORACLE, str(d / "in.npz"),
                          str(d / "out.npz")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


def test_secure_exchange_at_four_workers_equals_reference(four_workers):
    inp, ref = four_workers
    y, ok = col.secure_exchange(_t(inp["x"]), _mesh(4), "model",
                                key=ephemeral_edge_key("shuffle", seed=0),
                                step=11)
    assert ok.numpy().all() and ref["sx_ok"].all()
    assert np.array_equal(_u32(y), ref["sx_y"].view(np.uint32))
    assert np.array_equal(y.numpy(), inp["x"].swapaxes(0, 1))


@pytest.mark.parametrize("sealed", [False, True])
def test_keyed_route_at_four_workers_equals_reference(four_workers, sealed):
    inp, ref = four_workers
    name = "sealed" if sealed else "plain"
    key = ephemeral_edge_key("route", seed=1) if sealed else None
    kw = dict(step=4) if sealed else {}
    i, c, ok = router.route_keyed_sharded(_t(inp["rows"]),
                                          _t(inp["row_keys"]), _mesh(4),
                                          "model", key=key, **kw)
    assert np.array_equal(_u32(i), ref[f"kr_{name}_inbox"])
    assert np.array_equal(c.numpy(), ref[f"kr_{name}_counts"])
    assert np.array_equal(ok.numpy(), ref[f"kr_{name}_ok"])
    # every row arrives exactly once, at worker hash(key) % W
    assert int(c.sum()) == inp["rows"].shape[0] * inp["rows"].shape[1]
    dest = col._consistent_hash(_t(inp["row_keys"])) % 4
    for j in range(4):
        for src in range(4):
            want = inp["rows"][src][dest[src].numpy() == j]
            got = _u32(i[j, src])[:int(c[j, src])]
            assert np.array_equal(got, want)


def test_sealed_ppermute_at_four_workers_equals_reference(four_workers):
    inp, ref = four_workers
    y, ok = sealed_ppermute(ephemeral_edge_key("ring", seed=2), 7,
                            _t(inp["shards"]), [(0, 1), (1, 3), (3, 0)])
    assert ok.tolist() == ref["pp_ok"].tolist() == [True, True, False, True]
    assert np.array_equal(_u32(y), ref["pp_y"].view(np.uint32))


def test_a_flipped_wire_word_fails_exactly_its_block():
    """The sealed round's pieces, with the wire exposed: flip one word of
    block (src=2, dst=1) and only inbox[1, 2]'s verdict turns false."""
    W = 4
    x = _t(_inputs(W, seed=9)["x"])
    key = ephemeral_edge_key("shuffle", seed=0)
    kw = torch.from_numpy(key.key)
    nonces = col._route_nonces_base(W, 5 * W * W, CPU)
    ct, tags = aead.seal_many(kw, nonces, x.reshape(W * W, -1)
                              .view(torch.int32))
    wire = torch.cat([ct, tags], -1).reshape(W, W, -1)
    wire[2, 1, 3] ^= 0x100
    got = col.exchange(wire, _mesh(W)).reshape(W * W, -1)
    nonces_in = nonces.reshape(W, W, 3).transpose(0, 1).reshape(W * W, 3)
    _, ok = aead.open_many(kw, nonces_in, got[:, :-2], got[:, -2:])
    want = torch.ones((W, W), dtype=torch.bool)
    want[1, 2] = False
    assert torch.equal(ok.reshape(W, W), want)
