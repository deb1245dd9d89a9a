"""The port's train step for the ssm family (xlstm-125m at its
``reduce_for_smoke`` form) against the JAX reference on the CPU: two
AdamW steps and a step of two microbatches, in f32 (its gradients and
bf16 step are in ``tests/test_torch_train_families_ssm.py``).  The
checks and their tolerances are in ``tests/_torch_train_families.py``."""
import pytest

from _torch_families import make_ctx
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import check_microbatches, check_steps

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


def test_ssm_adamw_steps_equal_reference(ctx):
    check_steps(ctx, ARCH)


def test_ssm_microbatches_equal_reference(ctx):
    check_microbatches(ctx, ARCH)
