"""moe_roofline.prefill: the least time of the traced prefills' routed
expert products over the device time of the kernels that compute them
(names matching :data:`PATTERN`), in %.

Least time of a batch of T tokens: the larger of the routed experts'
FLOPs (2·3·d·d_expert an assignment, ``top_k`` assignments a token,
every MoE layer) over the bf16 peak and their bytes (each expert's
weights, each assignment's input and output row, once) over the memory
rate, as the configuration's family module counts them
(``routed_expert_flops``, ``routed_expert_bytes``).  None where the
family has no routed experts or the trace shows no such kernel.
"""
from portbench.lib import peaks, spec

#: the grouped expert products' kernels, pinned from the cell's trace
#: (NVIDIA H100, torch 2.11): ``torch._grouped_mm``'s CUTLASS GEMM over a
#: ``GroupProblemShape`` and the small kernel that lays out its groups'
#: problems on the card (``prepare_grouped_gemm_data``); no other kernel
#: there matches
PATTERN = r"GroupProblemShape|prepare_grouped_gemm"


def read(r):
    if r.trace is None:
        return None
    fam = spec.family(r.model)
    if not hasattr(fam, "routed_expert_flops"):
        return None
    spent = r.trace.device_s(PATTERN)
    if spent <= 0:
        return None
    return 100 * sum(peaks.least_seconds(
        fam.routed_expert_flops(r.model, B * S),
        fam.routed_expert_bytes(r.model, B * S))
        for B, S in r.traced_work) / spent
