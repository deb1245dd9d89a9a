"""The xLSTM config of the port (xlstm-125m: one mLSTM/sLSTM pair at its
``reduce_for_smoke`` form) against the JAX reference on the CPU.

The checks (f32 end to end, bf16 layer by layer, and their tolerances)
are in ``tests/_torch_families.py``.
"""
import pytest

from _torch_families import (check_bf16_layers_teacher_forced,
                             check_forward_and_loss, check_prefill_and_decode,
                             make_ctx)
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ['xlstm-125m']


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(ctx, arch):
    check_prefill_and_decode(ctx, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_reference(ctx, arch):
    check_forward_and_loss(ctx, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_teacher_forced(ctx, arch):
    check_bf16_layers_teacher_forced(ctx, arch)
