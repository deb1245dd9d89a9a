"""The MoE config kimi-k2-1t-a32b of the port at its ``reduce_for_smoke``
form against the JAX reference on the CPU.

The checks (f32 end to end here, bf16 layer by layer in
``tests/test_torch_families_kimi_layers.py``, and their tolerances) are
in ``tests/_torch_families.py``.
"""
import pytest

from _torch_families import (check_forward_and_loss, check_prefill_and_decode,
                             make_ctx)
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ['kimi-k2-1t-a32b']


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(ctx, arch):
    check_prefill_and_decode(ctx, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_reference(ctx, arch):
    check_forward_and_loss(ctx, arch)
