"""mfu.prefill: the window's prefills, in model FLOPs, over what the card's
bf16 peak gives in the window's time (host clock), in %.

A prefill of B prompts of S tokens: 2 FLOPs a token for each weight
element of the layers' products, causal attention at the real head dim
(4·D a (query, key) pair), and the LM head for the last position only.
The embedding is gathered, not multiplied.
"""
from portbench.lib import spec


def flops(m: dict, B: int, S: int) -> int:
    w = spec.matmul_weights(m)
    return 2 * w["layers"] * B * S + spec.attention_flops(m, B, S) \
        + 2 * w["lm_head"] * B


def read(r):
    total = sum(flops(r.model, B, S) for B, S in r.work)
    return 100 * total / (r.window_s * r.peaks.BF16_FLOPS)
