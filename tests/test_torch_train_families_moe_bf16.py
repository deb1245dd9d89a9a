"""The port's MoE train step (moonshot-v1-16b-a3b at its
``reduce_for_smoke`` form) in bf16 against the JAX reference's step
jitted in a subprocess that rounds every bf16 intermediate as its eager
form does: jitted with XLA's default excess precision, the reference's
MoE block routes a token to another expert than its eager block, which
the port matches bit for bit (ROADMAP Queue 3, "Divergences").  The
check and its tolerance are in ``tests/_torch_train_families.py``."""
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_families import check_step_bf16, reference_bf16_steps

ARCH = "moonshot-v1-16b-a3b"


def test_moe_bf16_step_equals_the_exact_bf16_reference(tmp_path):
    check_step_bf16(ARCH, reference_bf16_steps(tmp_path, [ARCH])[ARCH])
