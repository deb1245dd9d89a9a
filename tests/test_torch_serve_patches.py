"""The vision model's patches on the port's serving path, at the smoke
form of internvl2-76b against the JAX reference on the CPU (as
``chip_smoke.py`` phase 17 serves internvl2-76b on the card): the
patches are sealed beside the prompts (``serve.secure``, ChaCha20 +
CW-MAC) and opened bit-equal, and the prefill and the greedy tokens of
``serve.engine.greedy_generate`` with the opened patches equal the
reference's prefill and decode steps on the same patches, in f32 within
``tests/test_torch_families.py``'s tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (MAX_SEQ, S, _close, _close_trees, batches,
                             make_ctx, models)
from _torch_threads import one_torch_thread  # noqa: F401
from repro.models import api as j_api
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.serve import secure
from repro_torch.serve.engine import greedy_generate

ARCH = "internvl2-76b"
STEPS = MAX_SEQ - S + 1


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patches_seal_and_open_bit_equal(dtype):
    _, _, cfg, _ = models(ARCH, "float32")
    _, pb = batches(cfg, dtype)
    patches = pb["patches"]
    _, key, _ = secure.attested_session(cfg.arch_id)
    sealed = secure.seal_prompts(key, patches, counter=2)
    opened = secure.open_prompts(key, sealed)
    assert opened.dtype == patches.dtype and torch.equal(opened, patches)
    tampered = secure.seal_prompts(key, patches, counter=2)
    tampered.blocks[0, 0] ^= 1
    with pytest.raises(secure.RequestMacError):
        secure.open_prompts(key, tampered)


def test_served_with_opened_patches_equals_reference(ctx):
    jcfg, jp, cfg, p = models(ARCH, "float32")
    jb, pb = batches(cfg, "float32")
    _, key, _ = secure.attested_session(cfg.arch_id)
    opened = secure.open_prompts(key, secure.seal_prompts(
        key, pb["patches"], counter=2))
    tokens = pb["tokens"]
    jbatch = {"tokens": jb["tokens"], "patches": jb["patches"]}
    jlogits, jcache = j_api.prefill(jcfg, jp, jbatch, ctx, max_seq=MAX_SEQ)
    logits, cache = api.prefill(cfg, p, {"tokens": tokens,
                                         "patches": opened}, max_seq=MAX_SEQ)
    _close(logits, jlogits, "float32", "prefill logits")
    _close_trees(cache, {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                         for k, v in jcache.items()}, "float32", "cache")
    # the patches take part: without them the prefill differs
    plain, _ = api.prefill(cfg, p, {"tokens": tokens}, max_seq=MAX_SEQ)
    assert (plain - logits).abs().max() > 1e-3
    # greedy decoding after the prefill with the patches, step by step
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for pos in range(S, S + STEPS - 1):
        jl, jcache = j_api.decode_step(jcfg, jp, tok, jnp.int32(pos), jcache,
                                       ctx)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", S, tokens.shape[0],
                                                 "decode"))
    got = greedy_generate(run, p, tokens, steps=STEPS, max_seq=MAX_SEQ,
                          extra={"patches": opened})
    assert got.shape == (tokens.shape[0], STEPS)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))
