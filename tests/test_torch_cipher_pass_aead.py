"""The AEAD's public seal/open functions, batched and scalar, which run
the one-launch cipher pass (plain versions here, CPU tensors), against
the JAX reference's, on the CPU: ciphertext, tags, MAC keys and the
verdicts on tampered inputs, bit for bit.  Helpers are
``tests/test_torch_cipher_pass.py``'s."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.crypto import aead as j_aead
from repro_torch.crypto import aead
from repro_torch.u32 import to_numpy
from test_torch_cipher_pass import (_inputs, _ref_open, _ref_seal, _same,
                                    _t, _u32)
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("B,n,per_item", [(1, 1, False), (3, 16, True),
                                           (3, 37, False), (8, 5003, True)])
def test_seal_open_many_and_mac_keys_equal_reference(B, n, per_item):
    key, nonces, words = _inputs(B, n, per_item, seed=50 + n)
    jk, jn = jnp.asarray(key), jnp.asarray(nonces)
    jct, jtags = j_aead.seal_many(jk, jn, jnp.asarray(words), backend="jnp")
    ct, tags = aead.seal_many(_t(key), _t(nonces), _t(words))
    assert _same(ct, jct) and _same(tags, jtags)
    # tamper: one ciphertext word of the first item, one tag word of the
    # last; the verdicts are the reference's, item by item
    bad_ct, bad_tags = to_numpy(ct).copy(), to_numpy(tags).copy()
    bad_ct[0, n // 2] ^= 1
    bad_tags[-1, 1] ^= 1
    for c, tg in ((to_numpy(ct), to_numpy(tags)), (bad_ct, to_numpy(tags)),
                  (to_numpy(ct), bad_tags)):
        jpt, jok = j_aead.open_many(jk, jn, jnp.asarray(c), jnp.asarray(tg),
                                    backend="jnp")
        pt, ok = aead.open_many(_t(key), _t(nonces), _t(c), _t(tg))
        assert _same(pt, jpt)
        assert ok.tolist() == np.asarray(jok).tolist()
    assert _same(aead.derive_mac_keys_many(_t(key), _t(nonces)),
                 j_aead.derive_mac_keys_many(jk, jn))


@pytest.mark.parametrize("n", [1, 17, 5003])
def test_scalar_seal_open_equal_reference(n):
    key, nonce = _u32(8, 3 * n), _u32(3, 3 * n + 1)
    words = _u32(n, 3 * n + 2)
    jk, jn = jnp.asarray(key), jnp.asarray(nonce)
    jct, jtag = _ref_seal(jk, jn, jnp.asarray(words))
    ct, tag = aead.seal(_t(key), _t(nonce), _t(words))
    assert _same(ct, jct) and _same(tag, jtag)
    bad = to_numpy(ct).copy()
    bad[-1] ^= 1 << 31
    for c in (to_numpy(ct), bad):
        jpt, jok = _ref_open(jk, jn, jnp.asarray(c), jtag)
        pt, ok = aead.open_(_t(key), _t(nonce), _t(c), tag)
        assert _same(pt, jpt) and bool(ok) == bool(jok)
