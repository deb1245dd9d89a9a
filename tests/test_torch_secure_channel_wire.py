"""The port's ``SecureChannel`` and ``sealed_ppermute``
(``repro_torch.core.secure_channel``) against the reference's on the
CPU, bit for bit: ``SecureChannel`` on each package's
``KeyDirectory(seed)`` gives the same headers and ciphertexts across an
epoch flip and drains; ``sealed_ppermute`` over stacked shards equals the
reference's under ``shard_map`` at N = 1 (N = 4 on four host devices is
in ``tests/test_torch_collectives.py``, beside the other four-worker
oracles).  Helpers are ``tests/test_torch_secure_channel.py``'s."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, PartitionSpec as P

from repro.core import secure_channel as jsc
from repro.dist.compat import shard_map
from repro.dist.pipeline_parallel import edge_directory as j_edge_directory
from repro_torch.core import secure_channel as sc
from repro_torch.dist.pipeline_parallel import edge_directory
from repro_torch.obs.metrics import REGISTRY
from test_torch_secure_channel import _bits, _keys, _pair
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _fresh_port_registry():
    REGISTRY.reset()
    yield


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
