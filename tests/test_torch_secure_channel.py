"""The port's sealed channels (``repro_torch.core.secure_channel``) against
the reference's ``repro.core.secure_channel`` on the CPU, bit for bit:
``protect``/``unprotect`` and the batched ``protect_many``/
``unprotect_many`` give the reference's ciphertext words, tags and framing
meta for f32, bf16 and int32 tensors under per-item edge keys;
``SecureChannel`` and ``sealed_ppermute``:
``tests/test_torch_secure_channel_wire.py``.  The port frames its int32 tensors as ``"uint32"`` (int32 is
its word carrier); the reference frames a uint32 array so, and its int32
array as ``"int32"`` over the same words."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import ephemeral_edge_key as j_ephemeral_edge_key
from repro.core import secure_channel as jsc
from repro_torch.attest.directory import ephemeral_edge_key
from repro_torch.core import secure_channel as sc
from repro_torch.obs.metrics import REGISTRY
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _fresh_port_registry():
    REGISTRY.reset()
    yield


def _bits(t):
    """A tensor's (or jax array's) bits as a uint32/uint16/uint8 array."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    else:
        a = np.asarray(t)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _pair(shape, dtype, seed):
    """The same tensor in both packages: (jax array, torch tensor)."""
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        u16 = rng.integers(0, 2 ** 16, shape, dtype=np.uint16)
        return (jax.lax.bitcast_convert_type(jnp.asarray(u16), jnp.bfloat16),
                torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16))
    if dtype == "int32":
        a = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
            .astype(np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _keys(label="pp", seed=1):
    return (j_ephemeral_edge_key(label, seed=seed),
            ephemeral_edge_key(label, seed=seed))


DTYPES = ["float32", "bfloat16", "int32"]
SHAPES = [(4, 6), (3, 5, 7), (1,)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_protect_equals_reference(dtype, shape):
    jkey, key = _keys()
    jx, x = _pair(shape, dtype, seed=3)
    jct, jtag, jmeta = jsc.protect(jkey, 5, jx)
    ct, tag, meta = sc.protect(key, 5, x)
    assert np.array_equal(_bits(ct), _bits(jct))
    assert np.array_equal(_bits(tag), _bits(jtag))
    want_meta = jmeta if dtype != "int32" else \
        jsc.protect(jkey, 5, jax.lax.bitcast_convert_type(jx, jnp.uint32))[2]
    assert (tuple(meta[0]), meta[1], meta[2]) == \
        (tuple(want_meta[0]), want_meta[1], want_meta[2])
    # each package opens the other's ciphertext
    y, ok = sc.unprotect(key, 5, torch.from_numpy(_bits(jct).view(np.int32)
                                                  .copy()),
                         torch.from_numpy(_bits(jtag).view(np.int32).copy()),
                         meta)
    assert bool(ok) and np.array_equal(_bits(y), _bits(x))
    jy, jok = jsc.unprotect(jkey, 5, jnp.asarray(_bits(ct)),
                            jnp.asarray(_bits(tag)), jmeta)
    assert bool(jok) and np.array_equal(_bits(jy), _bits(jx))
    # the wrong step (nonce) fails in both
    assert not bool(sc.unprotect(key, 6, ct, tag, meta)[1])
    assert not bool(jsc.unprotect(jkey, 6, jct, jtag, jmeta)[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_protect_many_equals_reference_under_per_item_keys(dtype):
    labels = ("e0", "e1", "e2")
    jkeys = [j_ephemeral_edge_key(lb, seed=4) for lb in labels]
    keys = [ephemeral_edge_key(lb, seed=4) for lb in labels]
    steps = [5, 9, 2]
    jxs, xs = _pair((3, 4, 9), dtype, seed=6)
    jct, jtags, jmeta = jsc.protect_many(jkeys, steps, jxs)
    ct, tags, meta = sc.protect_many(keys, steps, xs)
    assert np.array_equal(_bits(ct), _bits(jct))
    assert np.array_equal(_bits(tags), _bits(jtags))
    assert tuple(meta[0]) == tuple(jmeta[0]) and meta[2] == jmeta[2]
    ys, oks = sc.unprotect_many(keys, steps, ct, tags, meta)
    assert oks.tolist() == [True] * 3
    assert np.array_equal(_bits(ys), _bits(xs))
    # one flipped wire word fails exactly its item, in both packages
    bad = ct.clone()
    bad[1, 2] ^= 1
    assert sc.unprotect_many(keys, steps, bad, tags, meta)[1].tolist() == \
        [True, False, True]
    jbad = jnp.asarray(_bits(bad))
    assert np.asarray(jsc.unprotect_many(jkeys, steps, jbad, jtags,
                                         jmeta)[1]).tolist() == \
        [True, False, True]
