"""The port's MoE FFN against the JAX reference's on the CPU at a
capacity factor that overflows: cf 0.25 gives 8 slots an expert for 128
assignments over 8 experts, so experts overflow and tokens are dropped
at the trash row.  The check and its tolerances are
``tests/test_torch_moe.py``'s."""
import pytest

from test_torch_moe import check_moe_ffn, ctx
from _torch_threads import one_torch_thread  # noqa: F401

__all__ = ["ctx"]                  # the fixture, shared


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.25])
def test_moe_ffn_equals_reference(ctx, cf, dtype):
    check_moe_ffn(ctx, cf, dtype)
