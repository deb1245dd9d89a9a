"""The MoE config moonshot-v1-16b-a3b of the port at its
``reduce_for_smoke`` form against the JAX reference on the CPU (kimi-k2's
is in ``test_torch_families_kimi.py``: the reference's eager MoE block
takes ~13 s a layer here).

The checks (f32 end to end here, bf16 layer by layer in
``tests/test_torch_families_moe_layers.py``, and their tolerances) are
in ``tests/_torch_families.py``.
"""
import pytest

from _torch_families import (check_forward_and_loss, check_prefill_and_decode,
                             make_ctx)
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ['moonshot-v1-16b-a3b']


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(ctx, arch):
    check_prefill_and_decode(ctx, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_reference(ctx, arch):
    check_forward_and_loss(ctx, arch)
