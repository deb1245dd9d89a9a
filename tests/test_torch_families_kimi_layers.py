"""The MoE config kimi-k2-1t-a32b of the port at its ``reduce_for_smoke``
form against the JAX reference on the CPU: each layer in bf16,
teacher-forced from the reference's own inputs.  The f32 end-to-end
checks are in ``tests/test_torch_families_kimi.py``; the checks and
their tolerances in ``tests/_torch_families.py``.
"""
import pytest

from _torch_families import check_bf16_layers_teacher_forced, make_ctx
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ['kimi-k2-1t-a32b']


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_layers_teacher_forced(ctx, arch):
    check_bf16_layers_teacher_forced(ctx, arch)
