"""The port's sealed channels (``repro_torch.core.secure_channel``) against
the reference's ``repro.core.secure_channel`` on the CPU, bit for bit:
``protect``/``unprotect`` and the batched ``protect_many``/
``unprotect_many`` give the reference's ciphertext words, tags and framing
meta for f32, bf16 and int32 tensors under per-item edge keys;
``SecureChannel`` on each package's ``KeyDirectory(seed)`` gives the same
headers and ciphertexts across an epoch flip and drains; and
``sealed_ppermute`` over stacked shards equals the reference's under
``shard_map`` at N = 1 (N = 4 on four host devices is in
``tests/test_torch_collectives.py``, beside the other four-worker
oracles).  The port frames its int32 tensors as ``"uint32"`` (int32 is
its word carrier); the reference frames a uint32 array so, and its int32
array as ``"int32"`` over the same words."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, PartitionSpec as P

from repro.attest.directory import ephemeral_edge_key as j_ephemeral_edge_key
from repro.core import secure_channel as jsc
from repro.dist.compat import shard_map
from repro.dist.pipeline_parallel import edge_directory as j_edge_directory
from repro_torch.attest.directory import ephemeral_edge_key
from repro_torch.core import secure_channel as sc
from repro_torch.dist.pipeline_parallel import edge_directory
from repro_torch.obs.metrics import REGISTRY


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


def test_secure_channel_equals_reference_across_an_epoch_flip():
    """Headers, ciphertexts and tags of single and window seals on each
    package's directory, before and after ``advance_epoch``; the chunks
    sealed before the flip still open after it (the drain path)."""
    jd, d = j_edge_directory(2, seed=11), edge_directory(2, seed=11)
    jch = jsc.SecureChannel(jd.handle("pp-edge1"))
    ch = sc.SecureChannel(d.handle("pp-edge1"))
    seals, jseals = [], []
    for i, flip in enumerate((False, False, True, False)):
        if flip:
            assert jd.advance_epoch() == d.advance_epoch()
        jx, x = _pair((8, 5), "float32", seed=20 + i)
        jwx, wx = _pair((3, 2, 7), "bfloat16", seed=30 + i)
        seals += [ch.protect(x), ch.protect_window(wx)]
        jseals += [jch.protect(jx), jch.protect_window(jwx)]
    for (h, ct, tag, _), (jh, jct, jtag, _) in zip(seals, jseals):
        assert tuple(h) == tuple(jh)
        assert np.array_equal(_bits(ct), _bits(jct))
        assert np.array_equal(_bits(tag), _bits(jtag))
    for k, (h, ct, tag, meta) in enumerate(seals):
        if k % 2 == 0:
            y, ok = ch.unprotect(h, ct, tag, meta)
            assert bool(ok)
        else:
            y, ok = ch.unprotect_window(h, ct, tag, meta)
            assert ok.tolist() == [True] * ct.shape[0]
    assert seals[0][0][1] != seals[-1][0][1]        # the epoch did flip


def test_sealed_ppermute_at_one_shard_equals_reference():
    jkey, key = _keys("ring", seed=2)
    jx, x = _pair((6, 4), "float32", seed=8)
    mesh = jax.make_mesh((1,), ("stage",), axis_types=(AxisType.Auto,))

    def body(perm):
        def f(xb):
            y, ok = jsc.sealed_ppermute(jkey, 3, xb[0], "stage", perm)
            return y[None], ok[None]
        return shard_map(f, mesh=mesh, in_specs=P("stage"),
                         out_specs=(P("stage"), P("stage")))

    for perm in ([(0, 0)], []):
        jy, jok = body(perm)(jx[None])
        y, ok = sc.sealed_ppermute(key, 3, x[None], perm)
        assert ok.tolist() == np.asarray(jok).tolist() == [bool(perm)]
        assert np.array_equal(_bits(y), _bits(jy))


def test_sealed_ppermute_delivers_each_sender_and_rejects_an_empty_slot():
    """Four shards, shard 2 receives nothing: every other shard opens the
    sender's tensor, shard 2 gets a zero payload and a False verdict, and
    no two shards' ciphertexts share a keystream."""
    _, key = _keys("ring4", seed=5)
    _, x = _pair((4, 3, 8), "float32", seed=9)
    perm = [(0, 1), (1, 3), (3, 0)]
    y, ok = sc.sealed_ppermute(key, 7, x, perm)
    assert ok.tolist() == [True, True, False, True]
    for s, d in perm:
        assert np.array_equal(_bits(y[d]), _bits(x[s]))
    # the same plaintext on every shard seals to distinct ciphertexts
    same = x[:1].repeat(4, 1, 1)
    words, _ = sc.aead.tensor_to_words_batch(same)
    kw = torch.from_numpy(key.key)
    nonces = torch.from_numpy(np.tile(key.nonce(7), (4, 1)))
    nonces[:, 0] = torch.arange(4)
    ct, _ = sc.aead.seal_many(kw, nonces, words)
    assert len({tuple(r) for r in ct.tolist()}) == 4
