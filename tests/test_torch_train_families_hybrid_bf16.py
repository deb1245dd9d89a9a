"""The port's train step for the hybrid family (zamba2-1.2b at its
``reduce_for_smoke`` form) in bf16 against the JAX reference's step
jitted in a subprocess that rounds every bf16 intermediate as its eager
form does.  The check and its tolerance are in
``tests/_torch_train_families.py``."""
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import check_step_bf16, reference_bf16_steps

ARCH = "zamba2-1.2b"


def test_hybrid_bf16_step_equals_the_exact_bf16_reference(tmp_path):
    check_step_bf16(ARCH, reference_bf16_steps(tmp_path, [ARCH])[ARCH])
