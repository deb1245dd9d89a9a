"""idle_optimizer_ms.train: the card's idle milliseconds a traced
training step (the pass with the host's activity) while
``train.optimizer`` is the innermost open one of the step's spans
(:data:`portbench.lib.spans.STEP_SPANS`): the optimizer's update with
its clipping.  None where the trace holds no ``train.optimizer``
span."""
from portbench.lib import spans


def read(r):
    return spans.idle_ms_a_step(r, "train.optimizer")
