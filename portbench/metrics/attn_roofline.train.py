"""attn_roofline.train: the least time of the attention work the traced
training steps run in kernels whose names match :data:`PATTERN`, over
those kernels' device time, in %.

Forward kernels (names without :data:`BACKWARD`) run once a layer, twice
under the cell's remat "full" (the backward recomputes each layer); the
least time of one: the larger of its FLOPs (4·D a causal (query, key)
pair) over the bf16 peak and its bytes (queries, keys, values, outputs
and the f32 log-sum-exp the backward reads, each once) over the memory
rate.  Backward kernels (names with :data:`BACKWARD`) run once a layer;
the least time of one: 10·D a pair (the scores recomputed, dV, dP, dQ,
dK) and, each once, the forward's bytes, the outputs' gradient read and
the queries', keys' and values' gradients written.  The FLOPs and bytes
are the configuration's family module's (those above: the dense one's).
A part the trace does not show adds nothing; None where it shows
neither.
"""
from portbench.lib import peaks, spec

#: names of attention kernels: kernel 7 and any that replaces it
PATTERN = r"flash|fmha|attention"
#: names of attention backward kernels, among those of PATTERN
BACKWARD = r"bwd|backward|grad"
FORWARD_ONLY = rf"^(?!.*({BACKWARD})).*({PATTERN})"
BACKWARD_ONLY = rf"^(?=.*({BACKWARD})).*({PATTERN})"


def least_seconds(m: dict, B: int, S: int) -> float:
    """One step's attention forwards, once a layer."""
    fam = spec.family(m)
    n = fam.attention_layers(m)
    return n * peaks.least_seconds(fam.attention_flops(m, B, S) / n,
                                   fam.attention_bytes(m, B, S, lse=True))


def least_backward_seconds(m: dict, B: int, S: int) -> float:
    """One step's attention backwards, once a layer; the gradients of the
    queries, keys, values and outputs have the bytes of the forward's
    inputs and output."""
    fam = spec.family(m)
    n = fam.attention_layers(m)
    grads = fam.attention_bytes(m, B, S, lse=False)
    return n * peaks.least_seconds(
        fam.attention_backward_flops(m, B, S) / n,
        fam.attention_bytes(m, B, S, lse=True) + grads)


def read(r):
    if r.trace is None:
        return None
    spent = r.trace.device_s(PATTERN)
    if spent <= 0:
        return None
    evals = 2 if r.traffic["remat"] == "full" else 1
    least = 0.0
    if r.trace.device_s(FORWARD_ONLY) > 0:
        least += evals * sum(least_seconds(r.model, B, S)
                             for B, S in r.traced_work)
    if r.trace.device_s(BACKWARD_ONLY) > 0:
        least += sum(least_backward_seconds(r.model, B, S)
                     for B, S in r.traced_work)
    return 100 * least / spent
