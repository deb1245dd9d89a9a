"""The port's training attention on the CPU against the JAX reference:
``models/flash.py``'s custom-VJP ``flash_attention`` (forward, its
log-sum-exp and dq/dk/dv), the ``"chunked"`` schedule (the flash
forward's plain version with autograd through it, against the
reference's ``chunked_attention``: forward and gradients) and
``hier_causal_attention``, at several (S, q_chunk, kv_chunk), f32 and
bf16.  The same inputs, made with numpy from a seed,
go to both; the reference is jitted.

Tolerances, stated per type:

* f32 (the algorithm): |got - want| <= 1e-5 + 1e-5 |want| — the same f32
  arithmetic summed in another order;
* bf16 (the working type): |got - want| <= 1e-2 + 2^-7 |want| — both sides
  compute in f32 from the same bf16 inputs and round the result to bf16
  once, so they may land one bf16 ulp (2^-8 relative) apart; a
  difference in the bf16 output also moves the backward's delta a little;
* the log-sum-exp is f32 in both types: 2e-5 absolute (values ~1..5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as j_flash
from repro.models import layers as j_layers
from repro.models.hier_attn import hier_causal_attention as j_hier
from repro_torch.models import flash
from repro_torch.models.hier_attn import hier_causal_attention
from _torch_threads import one_torch_thread  # noqa: F401

B, H, D = 2, 4, 16
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2 ** -7)}
LSE_TOL = 2e-5
CHUNKS = [(64, 16, 32), (64, 32, 16), (48, 16, 16), (32, 64, 64)]


def _close(got, want, dtype, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol, rtol = TOL[dtype]
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, f"{what}: max excess {excess.max()} ({dtype})"


def _inputs(S, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, S, H, D)).astype(np.float32)
              for _ in range(4)]                       # q, k, v, do
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


@functools.lru_cache(maxsize=None)
def _j_flash_vjp(qc, kc):
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: j_flash.flash_attention(
            a, b, c, True, qc, kc), q, k, v)
        _, lse = j_flash._flash_fwd_impl(q, k, v, True, qc, kc)
        return (out, lse) + vjp(do)
    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _j_chunked_vjp(qc, kc):
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: j_layers.chunked_attention(
            a, b, c, causal=True, q_chunk=qc, kv_chunk=kc), q, k, v)
        return (out,) + vjp(do.astype(out.dtype))
    return jax.jit(run)


def _port_vjp(fn, q, k, v, do):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    return (out,) + torch.autograd.grad(out, (q, k, v), do.to(out.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,qc,kc", CHUNKS)
def test_flash_forward_lse_and_grads_equal_reference(dtype, S, qc, kc):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(S, dtype, seed=S + qc + kc)
    jout, jlse, jdq, jdk, jdv = _j_flash_vjp(qc, kc)(jq, jk, jv, jdo)
    out, dq, dk, dv = _port_vjp(
        lambda a, b, c: flash.flash_attention(a, b, c, True, qc, kc),
        q, k, v, do)
    assert out.dtype == dq.dtype == q.dtype
    _close(out, jout, dtype, "out")
    for what, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        _close(got, want, dtype, what)
    _, lse = flash.flash_forward(q, k, v, True, qc, kc)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    err = np.abs(lse.transpose(1, 2).numpy() - np.asarray(jlse)).max()
    assert err <= LSE_TOL, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,qc,kc", CHUNKS[:2])
def test_chunked_attention_and_its_grads_equal_reference(dtype, S, qc, kc):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(S, dtype, seed=7 * S + qc)
    jout, jdq, jdk, jdv = _j_chunked_vjp(qc, kc)(jq, jk, jv, jdo)
    out, dq, dk, dv = _port_vjp(
        lambda a, b, c: flash.flash_forward_plain(a, b, c, True, qc, kc)[0],
        q, k, v, do)
    # in q's type: ``mha`` rounds the reference's f32 output to it
    assert out.dtype == q.dtype
    _close(out, jout, "float32" if dtype == "float32" else dtype, "out")
    for what, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        _close(got, want, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,base", [(64, 16), (64, 64), (128, 32)])
def test_hier_attention_equals_reference(dtype, S, base):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(S, dtype, seed=S + base)
    want = jax.jit(functools.partial(j_hier, base=base, q_chunk=16,
                                     kv_chunk=32))(jq, jk, jv)
    got = hier_causal_attention(q, k, v, base=base, q_chunk=16, kv_chunk=32)
    _close(got, want, dtype, "hier")


def test_flash_equals_the_plain_attention_it_computes():
    """Chunking changes nothing but the order of the sums: the Function's
    forward and gradients equal autograd through plain softmax attention
    (f32, 1e-5)."""
    _, (q, k, v, do) = _inputs(64, "float32", seed=3)
    got = _port_vjp(lambda a, b, c: flash.flash_attention(a, b, c, True, 16,
                                                          32), q, k, v, do)

    def plain(a, b, c):
        s = torch.einsum("bqhd,bkhd->bhqk", a, b) / D ** 0.5
        s = s.masked_fill(torch.ones(64, 64, dtype=torch.bool).triu(1),
                          float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), c)
    want = _port_vjp(plain, q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w.detach().numpy(), "float32")


@pytest.mark.parametrize("S,qc,kc", [(48, 32, 16), (48, 16, 32)])
def test_chunks_must_divide_the_sequence(S, qc, kc):
    """The reference asserts; the port raises ValueError.  A chunk longer
    than the sequence is clamped to it (the last case of CHUNKS runs)."""
    _, (q, k, v, _) = _inputs(S, "float32", seed=1)
    with pytest.raises(ValueError, match="multiples of the chunks"):
        flash.flash_attention(q, k, v, True, qc, kc)
    with pytest.raises(ValueError, match="multiples of the chunks"):
        flash.flash_forward_plain(q, k, v, True, qc, kc)
    with pytest.raises(AssertionError):
        j_flash.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                True, qc, kc)
