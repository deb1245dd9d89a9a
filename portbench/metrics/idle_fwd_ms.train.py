"""idle_fwd_ms.train: the card's idle milliseconds a traced training step
(the pass with the host's activity) while ``train.fwd`` is the innermost
open one of the step's spans (:data:`portbench.lib.spans.STEP_SPANS`):
the loss function's forward, one span a microbatch.  None where the
trace holds no ``train.fwd`` span."""
from portbench.lib import spans


def read(r):
    return spans.idle_ms_a_step(r, "train.fwd")
