"""idle_bwd_ms.train: the card's idle milliseconds a traced training step
(the pass with the host's activity) while ``train.bwd`` is the innermost
open one of the step's spans (:data:`portbench.lib.spans.STEP_SPANS`):
``torch.autograd.grad``, the remat recompute and every backward but the
attention's.  None where the trace holds no ``train.bwd`` span."""
from portbench.lib import spans


def read(r):
    return spans.idle_ms_a_step(r, "train.bwd")
