"""The port's train step for the vlm and audio families (internvl2-76b
and musicgen-large at their ``reduce_for_smoke`` forms: patches replace
the first positions' embeddings, frames are added to every position's,
each through the one ``frontend_proj`` projector) against the JAX
reference on the CPU: the gradients in f32 and one bf16 step each.
Their AdamW steps and microbatches are in
``tests/test_torch_train_families_frontends_steps.py``; the checks and
their tolerances in ``tests/_torch_train_families.py``."""
import pytest

from _torch_families import make_ctx
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import (check_grads, check_step_bf16,
                                   reference_bf16_steps)

ARCHS = ["internvl2-76b", "musicgen-large"]


@pytest.fixture(scope="module")
def ctx():
    return make_ctx()


@pytest.fixture(scope="module")
def bf16_reference(tmp_path_factory):
    return reference_bf16_steps(tmp_path_factory.mktemp("bf16"), ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_grads_equal_reference(ctx, arch):
    g = check_grads(ctx, arch)
    assert float(g["frontend_proj"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_bf16_step_equals_the_exact_bf16_reference(bf16_reference,
                                                            arch):
    check_step_bf16(arch, bf16_reference[arch])
