"""mfu.train: the window's training steps, in model FLOPs, over what the
card's bf16 peak gives in the window's time (host clock), in %.

A step of B x S tokens (T of them): 6 T FLOPs for each weight element
of the layers' products and the LM head (the forward, the input's and
the weight's gradients), 4 T for the front end's projector (its inputs
take no gradient), and 3 times the causal attention forward (4·D a
(query, key) pair).  Recomputation and the embedding's gathers are not
counted.
"""
from portbench.lib import spec


def flops(m: dict, B: int, S: int) -> int:
    w = spec.matmul_weights(m)
    T = B * S
    return 6 * T * (w["layers"] + w["lm_head"]) + 4 * T * w["frontend"] \
        + 3 * spec.attention_flops(m, B, S)


def read(r):
    total = sum(flops(r.model, B, S) for B, S in r.work)
    return 100 * total / (r.window_s * r.peaks.BF16_FLOPS)
