"""The port's train step for the hybrid family (zamba2-1.2b at its
``reduce_for_smoke`` form: Mamba2 layers on the chunked GLA scan, and one
weight-shared attention + MLP block after each full group) against the
JAX reference on the CPU: the gradients, with the groups cut to two
layers (seven layers, three calls of the shared block, so that the shared
block's gradient is a sum over its calls).  Its bf16 step is in
``tests/test_torch_train_families_hybrid_bf16.py``, its AdamW steps and
microbatches in ``tests/test_torch_train_families_hybrid_steps.py``;
the checks and their tolerances in ``tests/_torch_train_families.py``."""
import dataclasses

import pytest

from _torch_families import make_ctx
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import check_grads
from repro_torch.configs import get_model_config, reduce_for_smoke
from repro_torch.models import api

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


def test_hybrid_grads_with_three_shared_calls_equal_reference(ctx):
    cfg = reduce_for_smoke(get_model_config(ARCH))
    assert api.num_shared_attn(cfg) == 1
    assert api.num_shared_attn(dataclasses.replace(cfg, attn_every=2)) == 3
    g = check_grads(ctx, ARCH, attn_every=2)
    assert float(g["shared_attn"]["attn"]["wq"].abs().max()) > 0
