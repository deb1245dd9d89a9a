"""The port's fault tolerance over every seeded chaos plan, and the
reference's rekey acceptance run, on the CPU (the helpers and the rest
of the parity tests are in ``tests/test_torch_ft.py``).

All twenty plans of ``ChaosPlan.seeded`` over the 8-stage encrypted job
hold the port's terminal reduce bit-identical to its fault-free run,
with every fired fault audited exactly once; a plan replays bit for
bit; and the run with ``rekey_every_n=3``, a fatal crash, a rejected
spare enrollment and a stall lost to a backup equals the reference's,
event for event."""
from collections import Counter

import numpy as np
import pytest

from repro.ft.chaos import ChaosPlan as JChaosPlan, FaultSpec as JFaultSpec
from repro_torch.ft import ChaosPlan, FaultSpec
from test_torch_ft import TOPOLOGY, _build, _oracle, _policy, _run
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", range(20))
def test_seeded_chaos_sweep_bit_identical(seed):
    """Every seeded plan: the terminal reduce equals the fault-free run's
    and every fired fault has its exactly-once audit footprint."""
    want = _oracle()
    plan = ChaosPlan.seeded(seed, TOPOLOGY, rounds=3, n_faults=3)
    p = _build(chaos=plan, retry=_policy(), seed=100 + seed)
    out, _ = _run(p)
    assert np.array_equal(out, want)
    dump = p.directory.audit.dump()
    fired = {}
    for kind, stage, rnd, w in plan.events:
        fired.setdefault(kind, []).append((stage, rnd, w))

    def failed(reason, stage, rnd, w):
        return [e for e in dump if e["kind"] == "worker_failed"
                and e.get("reason") == reason and e.get("stage") == stage
                and e.get("round") == rnd
                and e.get("worker") == f"{stage}/w{w}"]

    for stage, rnd, w in fired.get("crash", []):
        assert len(failed("crash", stage, rnd, w)) == 1
        assert [e for e in dump
                if e["kind"] in ("share_retried", "share_failover")
                and e.get("stage") == stage and e.get("round") == rnd]
    for stage, rnd, w in fired.get("stall", []):
        assert len(failed("stall", stage, rnd, w)) == 1
    for reason, kind in (("mac_failure", "tamper"),
                         ("verdict_dropped", "drop_verdict")):
        want = Counter((s, r) for s, r, _ in fired.get(kind, []))
        got = Counter((e["stage"], e["round"]) for e in dump
                      if e["kind"] == "window_replayed"
                      and e.get("reason") == reason)
        assert got == want
        for stage, _ in want:
            if kind == "tamper":
                assert any(e["kind"] == "mac_failure"
                           and e.get("stage") == stage for e in dump)


def test_chaos_plan_replays_bit_for_bit():
    want = _oracle()
    plan = ChaosPlan.seeded(5, TOPOLOGY, rounds=3, n_faults=3)
    p = _build(chaos=plan, retry=_policy())
    out1, _ = _run(p)
    events = list(plan.events)
    plan.replay()
    assert plan.events == [] and not any(f.fired for f in plan.faults)
    out2, _ = _run(p)
    assert plan.events == events
    assert np.array_equal(out1, out2) and np.array_equal(out1, want)




def test_acceptance_rekey3_crash_stall_enroll_failure_matches_reference():
    """``rekey_every_n=3``, a fatal crash forcing a live spare whose
    first enrollment is rejected, and a stalled share lost to a backup:
    the port equals the reference, event for event."""
    def plan(spec):
        return [spec("crash", stage="s4", round=0, worker=0, when="after",
                     fatal=True),
                spec("enroll_fail"),
                spec("stall", stage="s2", round=1, worker=0, seconds=0.8)]
    want = _oracle(rekey=3)
    chaos = ChaosPlan(faults=plan(FaultSpec))
    p = _build(chaos=chaos, retry=_policy())
    jp = _build(chaos=JChaosPlan(faults=plan(JFaultSpec)),
                retry=_policy(False), port=False)
    out, syncs = _run(p, rekey_every_n=3)
    jout, jsyncs = _run(jp, port=False, rekey_every_n=3)
    assert np.array_equal(out, jout) and np.array_equal(out, want)
    assert not chaos.pending() and p._last_ft.chaos is chaos
    dump = p.directory.audit.dump()
    assert dump == jp.directory.audit.dump()
    assert p.report()["dispatch"] == jp.report()["dispatch"]
    assert syncs == jsyncs
    kinds = Counter(e["kind"] for e in dump)
    assert kinds["quote_rejected"] == 1 and kinds["share_failover"] >= 2
    assert p.stages[4].workers == 2 and p.directory.is_admitted("s4/w1")
    assert p.directory.epoch >= 2
    # the interceptor is the run's only: restored afterwards
    assert p.directory.admission_interceptor is None
