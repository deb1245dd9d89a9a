"""attn_roofline.prefill: the least time of the traced prefills' attention
forwards over the device time of the kernels whose names match
:data:`PATTERN`, in %.

Least time of one layer's forward: the larger of its FLOPs (of the dense
family 4·D a causal (query, key) pair) over the bf16 peak and its bytes
(queries, keys, values and outputs, each once) over the memory rate,
both as the configuration's family module counts them.  None where the
trace shows no such kernel.
"""
from portbench.lib import peaks, spec

#: names of attention kernels: kernel 7 and any that replaces it
PATTERN = r"flash|fmha|attention"


def least_seconds(m: dict, B: int, S: int) -> float:
    fam = spec.family(m)
    n = fam.attention_layers(m)
    return n * peaks.least_seconds(fam.attention_flops(m, B, S) / n,
                                   fam.attention_bytes(m, B, S, lse=False))


def read(r):
    if r.trace is None:
        return None
    spent = r.trace.device_s(PATTERN)
    if spent <= 0:
        return None
    return 100 * sum(least_seconds(r.model, B, S)
                     for B, S in r.traced_work) / spent
