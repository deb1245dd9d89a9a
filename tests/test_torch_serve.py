"""The secure serving flow of the torch port (``serve/secure.py`` +
``serve/engine.py``) against the reference's ``examples/secure_serve.py``
flow on the CPU: the client attests the serving enclave through a
``KeyDirectory(seed=7)``, seals its prompts (``ingress("encrypted")``),
the server opens them (``egress``, MAC checked), prefills and decodes
greedily.  Both directories derive the same session key, so the sealed
prompt words and tags are bit-equal across the packages; the generated
tokens are equal (f32 weights, so a greedy argmax cannot flip on a
rounding difference).  The reference's ``MeshContext`` is built on Auto
axes (ROADMAP Queue 3: ``local_mesh_context()`` fails under this jax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.attest.measure import IO_ENDPOINT as J_IO_ENDPOINT
from repro.attest.measure import measure_bytes as j_measure_bytes
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.core.enclave import egress as j_egress
from repro.core.enclave import ingress as j_ingress
from repro.dist.meshctx import MeshContext
from repro.models import api as j_api
from repro.serve.engine import make_decode_step as j_make_decode_step
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import build
from repro_torch.serve import secure
from repro_torch.serve.engine import greedy_generate
from repro_torch.u32 import to_numpy
from _torch_threads import one_torch_thread  # noqa: F401

# examples/secure_serve.py's model and flow, at a small size
CFG = dict(arch_id="serve-demo", family="dense", num_layers=2, d_model=128,
           num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=2048,
           head_dim=32, tie_embeddings=True)
REQUESTS, PROMPT, NEW = 2, 32, 6


def _reference_session():
    d = JKeyDirectory(seed=7)
    d.enroll("server", j_measure_bytes(b"serve-enclave", b"serve-demo"),
             allow=True)
    d.enroll("client", J_IO_ENDPOINT, allow=True)
    return d, d.establish("client-requests", "client", "server", stage_id=0)


def _prompts():
    return np.random.default_rng(0).integers(
        0, CFG["vocab_size"], (REQUESTS, PROMPT), dtype=np.int32)


@pytest.fixture(scope="module")
def sealed_pair():
    """(port key, port sealed chunk, reference key, reference chunk)."""
    _, key, server_m = secure.attested_session("serve-demo")
    assert server_m == j_measure_bytes(b"serve-enclave", b"serve-demo")
    _, jkey = _reference_session()
    prompts = _prompts()
    return (key, secure.seal_prompts(key, torch.from_numpy(prompts)), jkey,
            j_ingress("encrypted", jkey, 0, jnp.asarray(prompts)))


def test_sealed_prompts_are_bit_equal_to_the_reference(sealed_pair):
    key, sealed, jkey, jsealed = sealed_pair
    assert np.array_equal(np.asarray(key.key).view(np.uint32),
                          np.asarray(jkey.key).view(np.uint32))
    assert np.array_equal(to_numpy(sealed.blocks), np.asarray(jsealed.blocks))
    assert np.array_equal(to_numpy(sealed.tag), np.asarray(jsealed.tag))
    assert (sealed.n_words, sealed.counter, sealed.epoch) == (
        jsealed.n_words, jsealed.counter, jsealed.epoch)
    # the item shape and padding; int32 tokens are the port's u32 word
    # carrier, so its framing names them "uint32" (ROADMAP ground rules)
    assert (sealed.meta[0], sealed.meta[2]) == (jsealed.meta[0],
                                                jsealed.meta[2])
    # the ciphertext is not the prompt
    assert not np.array_equal(to_numpy(sealed.blocks).reshape(-1)[
        :sealed.n_words], _prompts().reshape(-1).view(np.uint32))


def test_the_server_opens_the_prompts_and_refuses_a_forgery(sealed_pair):
    key, sealed, jkey, jsealed = sealed_pair
    got = secure.open_prompts(key, sealed)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _prompts())
    jgot, jok = j_egress("encrypted", jkey, jsealed)
    assert bool(jok) and np.array_equal(np.asarray(jgot), got.numpy())
    forged = sealed.blocks.clone()
    forged[0, 0] ^= 1
    with pytest.raises(secure.RequestMacError):
        secure.open_prompts(key, type(sealed)(
            blocks=forged, tag=sealed.tag, counter=sealed.counter,
            meta=sealed.meta, n_words=sealed.n_words, epoch=sealed.epoch))


def test_secure_serving_generates_the_reference_tokens(sealed_pair):
    key, sealed, jkey, jsealed = sealed_pair
    jcfg = JModelConfig(**CFG)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      j_api.init_params(jcfg, jax.random.key(0)))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ctx = MeshContext(mesh=mesh, rules=JShardingConfig().lookup())

    # the reference example's serving loop
    jprompts, jok = j_egress("encrypted", jkey, jsealed)
    assert bool(jok)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig(
        "serve", PROMPT, REQUESTS, "decode"), optimizer=JOptimizerConfig())
    logits, cache = j_api.prefill(jcfg, jp, {"tokens": jprompts}, ctx,
                                  max_seq=PROMPT + NEW)
    decode = jax.jit(j_make_decode_step(jrun, ctx), donate_argnums=(3,))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    outs, pos = [tok], jnp.int32(PROMPT)
    for _ in range(NEW - 1):
        tok, _, cache = decode(jp, tok, pos, cache)
        outs.append(tok)
        pos = pos + 1
    want = np.asarray(jnp.concatenate(outs, axis=1))

    cfg = ModelConfig(**CFG)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", PROMPT, REQUESTS,
                                                 "decode"))
    prompts = secure.open_prompts(key, sealed)
    build.reset_launch_counts()
    got = greedy_generate(run, params, prompts, steps=NEW,
                          max_seq=PROMPT + NEW)
    assert np.array_equal(got.numpy(), want)
    # CPU tensors run the plain versions: no kernel was launched
    assert not any(build.launch_counts().values())
