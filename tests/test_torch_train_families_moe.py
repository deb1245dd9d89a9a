"""The port's train step for the MoE family (moonshot-v1-16b-a3b at its
``reduce_for_smoke`` form) against the JAX reference on the CPU: the
router, the Switch aux loss and the sort-based dispatch and combine under
autograd, in f32: loss, aux, every gradient; two AdamW steps;
microbatches 2 (its bf16 step is in
``tests/test_torch_train_families_moe_bf16.py``).  The checks and their
tolerances are in ``tests/_torch_train_families.py``."""
import pytest

from _torch_families import make_ctx
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import (check_grads, check_microbatches,
                                   check_steps)

ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


def test_moe_grads_equal_reference(ctx):
    check_grads(ctx, ARCH)


def test_moe_adamw_steps_equal_reference(ctx):
    check_steps(ctx, ARCH)


def test_moe_microbatches_with_aux_equal_reference(ctx):
    check_microbatches(ctx, ARCH)
