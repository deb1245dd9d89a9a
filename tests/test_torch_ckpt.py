"""The port's sealed checkpoints (``repro_torch.ckpt.checkpoint``) on the
CPU: the reference's checkpoint cases of ``tests/test_ckpt_ft.py`` in the
port (round trip, tamper, truncation, never-shared keystream, wrong seed,
``latest_step``), ``save_async``, and stores crossing packages in both
directions bit for bit: a small llama-shaped tree (bf16 params through
``interop.lm_params_from_numpy``'s keys, f32 optimiser moments) written
by the reference restores in the port and one written by the port
restores in the reference.  Also the port's copies of
``root_key_from_seed`` and ``poly1305_host``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import ModelConfig as JModelConfig
from repro.crypto import keys as jkeys
from repro.crypto import poly1305_host as jpoly
from repro.models import api as j_api
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.crypto import keys, poly1305_host
from repro_torch.interop import lm_params_from_numpy
from repro_torch.obs.metrics import REGISTRY
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _fresh_port_registry():
    REGISTRY.reset()
    yield


def _tiny_state():
    params = {"w": torch.arange(6.0).reshape(2, 3),
              "b": torch.ones((3,), dtype=torch.bfloat16)}
    opt = {"m": {k: torch.zeros_like(v) for k, v in params.items()}}
    return params, opt


def _leaves(tree):
    return ckpt._leaves(tree)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_sealed_checkpoint_roundtrip(tmp_path):
    params, opt = _tiny_state()
    path = str(tmp_path / "ck")
    ckpt.save(path, 7, params, opt, sealed=True, device=CPU)
    step, p2, o2 = ckpt.restore(path, params_like=params, opt_like=opt,
                                device=CPU)
    assert step == 7
    assert all(_same(a, b) for a, b in zip(_leaves(params), _leaves(p2)))
    assert all(_same(a, b) for a, b in zip(_leaves(opt), _leaves(o2)))
    assert list(p2) == list(params)              # the template's key order


def test_sealed_checkpoint_tamper_detected(tmp_path):
    params, opt = _tiny_state()
    path = str(tmp_path / "ck")
    final = ckpt.save(path, 3, params, opt, sealed=True, device=CPU)
    blob_path = os.path.join(final, "arrays.sealed")
    with open(blob_path, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0x01]))
    with pytest.raises(ValueError, match="AEAD verification FAILED"):
        ckpt.restore(path, params_like=params, opt_like=opt, device=CPU)


def test_sealed_checkpoint_truncation_detected(tmp_path):
    """Dropping trailing rows + their tags + shrinking n_bytes must fail
    the tag-list MAC — per-row MACs alone can't bind the row count."""
    params = {"w": torch.zeros((10000,), dtype=torch.float32)}  # 3 rows
    opt = {}
    path = str(tmp_path / "ck")
    final = ckpt.save(path, 2, params, opt, sealed=True, device=CPU)
    man_path = os.path.join(final, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    row_bytes = man["aead"]["row_words"] * 4
    blob_path = os.path.join(final, "arrays.sealed")
    with open(blob_path, "rb") as f:
        blob = f.read()
    assert len(blob) // row_bytes >= 2
    with open(blob_path, "wb") as f:                   # drop the last row
        f.write(blob[:-row_bytes])
    man["aead"]["tags"] = man["aead"]["tags"][:-16]    # ...and its tag
    man["aead"]["n_bytes"] = (len(blob) - row_bytes)   # ...and the length
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="tag list"):
        ckpt.restore(path, params_like=params, opt_like=opt, device=CPU)


def test_sealed_checkpoints_never_share_keystream(tmp_path):
    """Two stores sealed with the same seed + step must not reuse a
    ChaCha20 keystream (the per-store salt separates the keys)."""
    a = {"w": torch.zeros((4096,), dtype=torch.float32)}
    b = {"w": torch.ones((4096,), dtype=torch.float32)}
    fa = ckpt.save(str(tmp_path / "a"), 5, a, {}, sealed=True, seed=0,
                   device=CPU)
    fb = ckpt.save(str(tmp_path / "b"), 5, b, {}, sealed=True, seed=0,
                   device=CPU)
    with open(os.path.join(fa, "arrays.sealed"), "rb") as f:
        ba = f.read()
    with open(os.path.join(fb, "arrays.sealed"), "rb") as f:
        bb = f.read()
    n = min(len(ba), len(bb))
    xor = np.frombuffer(ba[:n], np.uint8) ^ np.frombuffer(bb[:n], np.uint8)
    assert np.unique(xor).size > 64


def test_checkpoint_wrong_seed_fails(tmp_path):
    params, opt = _tiny_state()
    path = str(tmp_path / "ck")
    ckpt.save(path, 1, params, opt, sealed=True, seed=0, device=CPU)
    with pytest.raises(ValueError):
        ckpt.restore(path, params_like=params, opt_like=opt, seed=99,
                     device=CPU)


def test_latest_step_selection(tmp_path):
    params, opt = _tiny_state()
    path = str(tmp_path / "ck")
    assert ckpt.latest_step(path) is None
    for s in (5, 10, 20):
        ckpt.save(path, s, params, opt, sealed=False, device=CPU)
    assert ckpt.latest_step(path) == 20
    step, p2, _ = ckpt.restore(path, params_like=params, opt_like=opt,
                               device=CPU)
    assert step == 20
    assert all(_same(a, b) for a, b in zip(_leaves(params), _leaves(p2)))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), params_like=params,
                     opt_like=opt, device=CPU)


def test_save_async_copies_before_returning(tmp_path):
    params, opt = _tiny_state()
    want = [t.clone() for t in _leaves(params)]
    t = ckpt.save_async(str(tmp_path / "ck"), 4, params, opt, device=CPU)
    params["w"].add_(100.0)                # the caller mutates its buffer
    t.join(timeout=60)
    assert not t.is_alive()
    _, p2, _ = ckpt.restore(str(tmp_path / "ck"), params_like=params,
                            opt_like=opt, device=CPU)
    assert all(_same(a, b) for a, b in zip(want, _leaves(p2)))


# ---------------------------------------------------- across the packages

CFG = dict(arch_id="ckpt-test", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
           head_dim=16, tie_embeddings=True)


@pytest.fixture(scope="module")
def trees():
    """(reference params, opt) and the port's (params, opt) holding the
    same bits: bf16 params, f32 moments, a list, a tuple and a None."""
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    jp = j_api.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    jm = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jp)
    jopt = {"m": jm, "count": [jnp.asarray(np.int32(3)), None],
            "pair": (jnp.arange(4, dtype=jnp.float32),)}
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    m = lm_params_from_numpy(jax.tree.map(np.asarray, jm), cfg, device=CPU)
    opt = {"m": m, "count": [torch.tensor(3, dtype=torch.int32), None],
           "pair": (torch.arange(4, dtype=torch.float32),)}
    return (jp, jopt), (p, opt)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _equal_trees(port_tree, ref_tree):
    a, b = _leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert np.array_equal(_bits(x), _bits(y))
        assert _bits(x).dtype == _bits(y).dtype


def test_flatten_order_and_treedef_are_the_references(trees):
    (jp, jopt), (p, opt) = trees
    assert {x.dtype for x in _leaves(p)} == {torch.bfloat16}
    assert torch.float32 in {x.dtype for x in _leaves(opt)}
    _equal_trees(p, jp)
    _equal_trees(opt, jopt)
    for tree, jtree in ((p, jp), (opt, jopt)):
        assert ckpt._treedef(tree) == str(jax.tree.structure(jtree))


@pytest.mark.parametrize("sealed", [True, False])
def test_reference_store_restores_in_the_port(tmp_path, trees, sealed):
    (jp, jopt), (p, opt) = trees
    jckpt.save(str(tmp_path), 9, jp, jopt, sealed=sealed, seed=3)
    step, p2, o2 = ckpt.restore(str(tmp_path), seed=3, params_like=p,
                                opt_like=opt, device=CPU)
    assert step == 9
    _equal_trees(p2, jp)
    _equal_trees(o2, jopt)


@pytest.mark.parametrize("sealed", [True, False])
def test_port_store_restores_in_the_reference(tmp_path, trees, sealed):
    (jp, jopt), (p, opt) = trees
    final = ckpt.save(str(tmp_path), 12, p, opt, sealed=sealed, seed=3,
                      device=CPU)
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    assert man["treedefs"]["params"] == str(jax.tree.structure(jp))
    step, jp2, jo2 = jckpt.restore(str(tmp_path), seed=3, params_like=jp,
                                   opt_like=jopt)
    assert step == 12
    _equal_trees(p, jp2)
    _equal_trees(opt, jo2)


def test_same_blob_seals_to_the_same_rows_and_tags(monkeypatch):
    """Under one salt, the port's seal of a blob is the reference's, row
    for row (ciphertext, tags, manifest MAC)."""
    data = np.random.default_rng(2).bytes(3 * 4096 * 4 + 123)
    fixed = bytes(range(16))
    monkeypatch.setattr(os, "urandom", lambda n: fixed[:n])
    jct, jmeta = jckpt._seal_blob(jckpt._seal_key(5), 6, data)
    ct, meta = ckpt._seal_blob(ckpt._seal_key(5), 6, data, torch.device(CPU))
    assert ct.tobytes() == jct
    assert meta == jmeta


def test_root_key_and_poly1305_equal_the_references():
    for seed in (0, 1, 12345):
        assert keys.root_key_from_seed(seed) == jkeys.root_key_from_seed(seed)
    # RFC 7539 §2.5.2
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a8"
                        "0103808afb0db2fd4abff6af4149f51b")
    msg = b"Cryptographic Forum Research Group"
    tag = bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")
    assert poly1305_host.poly1305(key, msg) == jpoly.poly1305(key, msg) == tag
    assert poly1305_host.poly1305_verify(key, msg, tag)
    assert not poly1305_host.poly1305_verify(key, msg + b".", tag)
    rng = np.random.default_rng(0)
    for n in (0, 1, 15, 16, 17, 100):
        k, m = rng.bytes(32), rng.bytes(n)
        assert poly1305_host.poly1305(k, m) == jpoly.poly1305(k, m)
    with pytest.raises(ValueError):
        poly1305_host.poly1305(key[:16], msg)
