"""The port's train step for the ssm family (xlstm-125m at its
``reduce_for_smoke`` form: mLSTM on the chunked GLA scan with its
normaliser, the sLSTM's per-token loop under autograd) against the JAX
reference on the CPU: the gradients in f32 and one bf16 step.  Its AdamW
steps and microbatches are in
``tests/test_torch_train_families_ssm_steps.py``; the checks and their
tolerances in ``tests/_torch_train_families.py``."""
import pytest

from _torch_families import make_ctx
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import (check_grads, check_step_bf16,
                                   reference_bf16_steps)

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


def test_ssm_grads_equal_reference(ctx):
    g = check_grads(ctx, ARCH)
    assert float(g["layers"]["slstm"]["r_z"].abs().max()) > 0


def test_ssm_bf16_step_equals_the_exact_bf16_reference(tmp_path):
    check_step_bf16(ARCH, reference_bf16_steps(tmp_path, [ARCH])[ARCH])
