"""The port's chunked gated linear attention (``models/gla.py``) against
the JAX reference's (``repro/models/gla.py``) on the CPU.

The same f32 inputs (made from a seed with numpy) go through both:
``chunked_gla`` for several lengths and chunks, normalised or not, with a
carried-in state and its final state; ``gla_decode_step``; and the
sequential oracle ``gla_reference``, which ``chunked_gla`` must also
equal in each package.  Tolerance: 2e-5 + 1e-5·|want| (all f32; the
chunked and sequential forms sum in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gla as j_gla
from repro_torch.models import gla
from _torch_threads import one_torch_thread  # noqa: F401


def _close(got, want, atol=2e-5, rtol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, excess.max()


def _inputs(B, S, H, Dk, Dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, Dk)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, S, H, Dk)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    log_f = -rng.uniform(0.0, 0.3, (B, S, H)).astype(np.float32)
    i_gate = rng.uniform(0.0, 1.0, (B, S, H)).astype(np.float32)
    return q, k, v, log_f, i_gate


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("S,chunk", [(32, 8), (48, 16), (64, 64), (16, 256)])
def test_chunked_gla_equals_reference_and_the_recurrence(S, chunk,
                                                         normalize):
    ja, ta = _both(_inputs(2, S, 3, 8, 6, seed=S + chunk))
    jy, (jS, jn) = j_gla.chunked_gla(*ja, chunk=chunk, normalize=normalize,
                                     return_state=True)
    y, (St, nt) = gla.chunked_gla(*ta, chunk=chunk, normalize=normalize,
                                  return_state=True)
    _close(y, jy)
    _close(St, jS)
    _close(nt, jn)
    _close(y, gla.gla_reference(*ta, normalize=normalize))
    _close(gla.gla_reference(*ta, normalize=normalize),
           j_gla.gla_reference(*ja, normalize=normalize))


@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_gla_continues_a_carried_state(normalize):
    """Two halves with the first half's state carried in equal the whole
    (the prefill-then-continue path of Mamba2 and mLSTM)."""
    ja, ta = _both(_inputs(1, 64, 2, 8, 8, seed=5))
    y, st = gla.chunked_gla(*(t[:, :32] for t in ta), chunk=16,
                            normalize=normalize, return_state=True)
    y2 = gla.chunked_gla(*(t[:, 32:] for t in ta), chunk=16,
                         normalize=normalize, init_state=st)
    whole = gla.chunked_gla(*ta, chunk=16, normalize=normalize)
    _close(torch.cat([y, y2], dim=1), whole)
    jy, jst = j_gla.chunked_gla(*(a[:, :32] for a in ja), chunk=16,
                                normalize=normalize, return_state=True)
    jy2 = j_gla.chunked_gla(*(a[:, 32:] for a in ja), chunk=16,
                            normalize=normalize, init_state=jst)
    _close(y2, jy2)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_decode_step_equals_reference(normalize):
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((2, 3, 8), (2, 3, 8), (2, 3, 6))]
    arrays += [-rng.uniform(0, 0.3, (2, 3)).astype(np.float32),
               rng.uniform(0, 1, (2, 3)).astype(np.float32),
               rng.standard_normal((2, 3, 8, 6)).astype(np.float32),
               rng.standard_normal((2, 3, 8)).astype(np.float32)]
    ja, ta = _both(arrays)
    jy, (jS, jn) = j_gla.gla_decode_step(*ja[:5], (ja[5], ja[6]),
                                         normalize=normalize)
    y, (St, nt) = gla.gla_decode_step(*ta[:5], (ta[5], ta[6]),
                                      normalize=normalize)
    _close(y, jy)
    _close(St, jS)
    _close(nt, jn)


def test_chunked_gla_keeps_the_whole_chunks_assertion():
    _, ta = _both(_inputs(1, 24, 1, 4, 4, seed=1))
    with pytest.raises(AssertionError):
        gla.chunked_gla(*ta, chunk=16)
    assert gla.NEG_BIG == j_gla.NEG_BIG
    assert float(torch.exp(torch.tensor(gla.NEG_BIG))) == 0.0
