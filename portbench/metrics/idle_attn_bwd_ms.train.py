"""idle_attn_bwd_ms.train: the card's idle milliseconds a traced training
step (the pass with the host's activity) while ``attn.bwd`` is the
innermost open one of the step's spans
(:data:`portbench.lib.spans.STEP_SPANS`): the attention's backward
(``models.flash``), opened on autograd's thread inside ``train.bwd``.
None where the trace holds no ``attn.bwd`` span."""
from portbench.lib import spans


def read(r):
    return spans.idle_ms_a_step(r, "attn.bwd")
