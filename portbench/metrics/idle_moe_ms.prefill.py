"""idle_moe_ms.prefill: the card's idle ms a traced batch while one of the
program's MoE spans (``moe.route``, ``moe.experts``, ``moe.shared``,
``repro_torch.models.moe``) is the innermost open one of them, in the
pass of the trace with the host (``lib/spans.idle_ns``).  A host sync in
the dispatch (the host waiting on the card, then the card on the host)
shows here.  None where the run has no trace or the trace holds no MoE
span."""
from portbench.lib.spans import idle_ns

#: the program's MoE spans
SPANS = ("moe.route", "moe.experts", "moe.shared")


def read(r):
    if r.trace is None or not r.traced_work:
        return None
    got = idle_ns(r.trace, SPANS)
    held = [n for n in SPANS if n in got]
    if not held:
        return None
    return sum(got[n] for n in held) / 1e6 / len(r.traced_work)
