"""xLSTM's mLSTM and sLSTM blocks (``models/xlstm.py``: forward, forward
with its decode cache, and the decode step that continues from it)
against the JAX reference's on the CPU, at the smoke config's widths, in
f32 and bf16.  The checks, weights and tolerances are
``tests/test_torch_ssm.py``'s."""
import pytest

from test_torch_ssm import (XLSTM_CASES, check_block, check_decode_continues,
                            ctx)
from _torch_threads import one_torch_thread  # noqa: F401

__all__ = ["ctx"]                  # the fixture, shared


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", XLSTM_CASES,
                         ids=[c[1] for c in XLSTM_CASES])
def test_block_forward_state_and_decode_equal_reference(ctx, case, dtype):
    check_block(ctx, case, dtype)


@pytest.mark.parametrize("key", ["mlstm"])
def test_decode_continues_the_forward(key):
    check_decode_continues(key)
