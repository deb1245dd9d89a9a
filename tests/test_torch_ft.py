"""The port's fault tolerance (retry, failover, speculative backup,
replay) under seeded chaos, against the JAX reference and against its
own fault-free runs, on the CPU.

The 8-stage encrypted job of ``tests/test_chaos.py`` runs in both
packages under the same fault plans: terminal reduce, fired faults,
audit stream, dispatch accounting and host syncs are equal.  No recovery
ever seals twice under one (key, nonce) on either cipher path (the AEAD
seal and, in enclave mode, the fused kernel's outbound nonces), and the
tamper writes a copy.  The reference runs its jitted encrypted mode.
The twenty-seed sweep and the rekey acceptance run are in
``tests/test_torch_ft_sweep.py``, so each file stays short."""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attest.directory import KeyDirectory as JKeyDirectory
from repro.configs.base import SecureStreamConfig as JConfig
from repro.core import enclave as j_enclave
from repro.core import pipeline as j_pipeline_mod
from repro.core.pipeline import Pipeline as JPipeline, Stage as JStage
from repro.ft.chaos import ChaosPlan as JChaosPlan, FaultSpec as JFaultSpec
from repro.ft.retry import RetryPolicy as JRetryPolicy
from repro.obs import REGISTRY as J_REGISTRY
from repro_torch.attest.directory import KeyDirectory
from repro_torch.configs.base import SecureStreamConfig
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.enclave import SealedWindow
from repro_torch.crypto import aead
from repro_torch.ft import (BackupDispatcher, ChaosPlan, FaultSpec,
                            ReplayBuffer, RetryPolicy, StragglerDetector)
from repro_torch.kernels.enclave_map import ops as enclave_ops
from repro_torch.obs import REGISTRY
from repro_torch.u32 import from_numpy, to_numpy
from _torch_threads import one_torch_thread  # noqa: F401

N_CHUNKS = 12
CHUNK = 64
TOPOLOGY = [(f"s{i}", 2 if i == 2 else 1) for i in range(8)]
#: the seeds held against the reference (all twenty against the port's
#: own fault-free run): between them every fault kind, a fatal crash, a
#: crash on the two-worker stage and faults sharing a round
REFERENCE_SEEDS = (0, 3, 7, 11)


def _sum_reduce(acc, x):
    return x if acc is None else acc + x


def _stages8(cls):
    sts = [cls(f"s{i}", "scale_f32", const=1.0 + 0.125 * i,
               workers=2 if i == 2 else 1) for i in range(8)]
    sts.append(cls("sink", "custom", reduce_fn=_sum_reduce,
                   reduce_init=None))
    return sts


def _records():
    return [np.random.RandomState(41 + i).rand(CHUNK).astype(np.float32)
            for i in range(N_CHUNKS)]


def _build(chaos=None, retry=None, seed=7, mode="encrypted", port=True):
    if port:
        return pipeline_mod.Pipeline(
            _stages8(pipeline_mod.Stage), SecureStreamConfig(mode=mode),
            seed=seed, directory=KeyDirectory(seed=seed, epoch_history=64),
            window_chunks=4, retry=retry, chaos=chaos, device="cpu")
    return JPipeline(_stages8(JStage), JConfig(mode=mode), seed=seed,
                     directory=JKeyDirectory(seed=seed, epoch_history=64),
                     window_chunks=4, retry=retry, chaos=chaos)


def _run(p, port=True, **kw):
    """-> (terminal reduce as numpy, host syncs of the run)."""
    mod = pipeline_mod if port else j_pipeline_mod
    (REGISTRY if port else J_REGISTRY).reset()
    mod.reset_host_sync_count()
    src = [torch.as_tensor(c) if port else jnp.asarray(c)
           for c in _records()]
    out = p.run(iter(src), **kw)
    return np.asarray(out), mod.host_sync_count()


_ORACLE = {}


def _oracle(rekey=None):
    """The port's fault-free terminal reduce, once per rekey cadence."""
    if rekey not in _ORACLE:
        _ORACLE[rekey] = _run(_build(), rekey_every_n=rekey)[0]
    return _ORACLE[rekey]


def _no_sleep(_seconds):
    return None


def _policy(port=True, **kw):
    """The tests' policy: a pinned stall cutoff (injected stalls of 0.5 s
    and more always exceed it, on any machine) and no real sleep."""
    cls = RetryPolicy if port else JRetryPolicy
    return cls(share_timeout_s=0.25, sleep=_no_sleep, **kw)


# ------------------------------------------------------- plans and parity


@pytest.mark.parametrize("seed", range(20))
def test_seeded_plans_equal_reference(seed):
    plan = ChaosPlan.seeded(seed, TOPOLOGY, rounds=3, n_faults=3)
    jplan = JChaosPlan.seeded(seed, TOPOLOGY, rounds=3, n_faults=3)
    assert [asdict(f) for f in plan.faults] == \
        [asdict(f) for f in jplan.faults]
    assert plan.seed == jplan.seed == seed


@pytest.mark.parametrize("seed", REFERENCE_SEEDS)
def test_seeded_chaos_run_matches_reference(seed):
    """Same plan, same records, both packages: the terminal reduce, the
    faults in firing order, the whole audit stream, the dispatch
    accounting and the host syncs are equal."""
    want = _oracle()
    plan = ChaosPlan.seeded(seed, TOPOLOGY, rounds=3, n_faults=3)
    jplan = JChaosPlan.seeded(seed, TOPOLOGY, rounds=3, n_faults=3)
    p = _build(chaos=plan, retry=_policy(), seed=100 + seed)
    jp = _build(chaos=jplan, retry=_policy(False), seed=100 + seed,
                port=False)
    out, syncs = _run(p)
    jout, jsyncs = _run(jp, port=False)
    assert np.array_equal(out, jout) and np.array_equal(out, want)
    assert plan.events == jplan.events and not plan.pending()
    assert p.directory.audit.dump() == jp.directory.audit.dump()
    assert p.report()["dispatch"] == jp.report()["dispatch"]
    assert syncs == jsyncs
    for name in ("retries", "failovers", "backups", "replays",
                 "worker_failures", "enroll_failures"):
        assert REGISTRY.get(f"ft.{name}").value == \
            J_REGISTRY.get(f"ft.{name}").value, name


# ------------------------------------------------------- nonce discipline


FAULTS_ON_EVERY_PATH = (
    # crashes AFTER the share ran: the first coordinates were already
    # spent on the outbound key, the harshest retry case
    ("crash", dict(stage="s1", round=0, worker=0, when="after")),
    ("crash", dict(stage="s3", round=1, worker=0, when="after")),
    ("tamper", dict(stage="s4", round=0, worker=0, rows=2)),
    ("drop_verdict", dict(stage="s6", round=1, worker=0)),
    ("stall", dict(stage="s2", round=1, worker=1, seconds=0.6)),
)


@pytest.mark.parametrize("mode", ["encrypted", "enclave"])
def test_recovery_never_reuses_key_nonce(monkeypatch, mode):
    """Every outbound (key, nonce) is spent once: the AEAD's seals (every
    hop in encrypted mode, the ingress in enclave mode) and the fused
    enclave kernel's outbound nonces (``nonces_out`` on a re-execution,
    the inbound ones otherwise), across retry, backup, tamper replay and
    dropped-verdict replay under ``rekey_every_n=3``.  A re-execution
    that sealed under its first coordinates would still decrypt (counters
    do not change plaintext): only this record shows it."""
    want = _oracle(rekey=3)
    seen = set()

    def record(keys, nonces):
        keys, nonces = to_numpy(keys), to_numpy(nonces)
        for b in range(nonces.shape[0]):
            kn = ((keys if keys.ndim == 1 else keys[b]).tobytes(),
                  nonces[b].tobytes())
            assert kn not in seen, "(key, nonce) spent twice by a recovery"
            seen.add(kn)

    real_seal_many = aead.seal_many
    real_hop = enclave_ops.enclave_map_window

    def seal_many(keys, nonces, words):
        record(keys, nonces)
        return real_seal_many(keys, nonces, words)

    def hop(keys_in, keys_out, nonces_in, words, *, op, const=0.0,
            nonces_out=None):
        record(keys_out, nonces_in if nonces_out is None else nonces_out)
        return real_hop(keys_in, keys_out, nonces_in, words, op=op,
                        const=const, nonces_out=nonces_out)

    monkeypatch.setattr(aead, "seal_many", seal_many)
    monkeypatch.setattr(enclave_ops, "enclave_map_window", hop)
    plan = ChaosPlan(faults=[FaultSpec(k, **kw)
                             for k, kw in FAULTS_ON_EVERY_PATH])
    p = _build(chaos=plan, retry=_policy(), mode=mode)
    out, _ = _run(p, rekey_every_n=3)
    assert not plan.pending()
    assert np.array_equal(out, want)
    ft = p._last_ft
    assert ft.retries.value == 2 and ft.backups.value == 1
    assert ft.replays.value == 2
    # ingress + every hop + every re-execution
    assert len(seen) > N_CHUNKS * 9


def test_ft_counts_shares_and_executions_by_stage_and_round(monkeypatch):
    """The engine's own record of an enclave-mode run under a fault of
    every kind (``FTContext.shares`` / ``executions`` by (stage, round)):
    every window hop is one execution, and in each (stage, round) the
    executions are its shares plus the launches the audit log shows a
    fault wasted there (a crash after its share ran, a backup's slow
    original, a replay)."""
    from collections import Counter
    hops = Counter()
    real_hop = enclave_ops.enclave_map_window

    def hop(*args, **kw):
        hops["all"] += 1
        return real_hop(*args, **kw)

    monkeypatch.setattr(enclave_ops, "enclave_map_window", hop)
    plan = ChaosPlan(faults=[FaultSpec(k, **kw)
                             for k, kw in FAULTS_ON_EVERY_PATH])
    p = _build(chaos=plan, retry=_policy(), mode="enclave")
    out, _ = _run(p, rekey_every_n=3)
    assert not plan.pending()
    assert np.array_equal(out, _oracle(rekey=3))
    ft = p._last_ft
    wasted = Counter((e["stage"], e["round"])
                     for e in p.directory.audit.dump()
                     if (e["kind"] == "worker_failed"
                         and e["reason"] == "crash")
                     or (e["kind"] == "share_failover"
                         and e["reason"] == "backup")
                     or e["kind"] == "window_replayed")
    assert sum(wasted.values()) == 2 + 1 + 2
    assert set(wasted) <= set(ft.shares) == set(ft.executions)
    assert {at: ft.executions[at] - ft.shares[at] for at in ft.shares
            if ft.executions[at] != ft.shares[at]} == dict(wasted)
    assert sum(ft.executions.values()) == hops["all"]
    # one share an id drawn
    assert sum(ft.shares.values()) == ft.next_share_id() > 8 * 3


def test_enclave_mode_crash_and_tamper_bit_identical():
    """The fused kernel's re-seal path (``nonces_out``) through a crash
    retry and a tamper replay: equal to the fault-free run and to numpy's
    float32 chain."""
    def sts():
        return [pipeline_mod.Stage("a", "scale_f32", const=1.5, workers=2),
                pipeline_mod.Stage("b", "relu_f32"),
                pipeline_mod.Stage("sink", "custom", reduce_fn=_sum_reduce,
                                   reduce_init=None)]
    xs = [np.random.RandomState(3 + i).rand(32).astype(np.float32) - 0.5
          for i in range(8)]

    def run(**kw):
        p = pipeline_mod.Pipeline(
            sts(), SecureStreamConfig(mode="enclave"), seed=3,
            directory=KeyDirectory(seed=3, epoch_history=64),
            window_chunks=4, device="cpu", **kw)
        return p, p.run(iter(torch.as_tensor(x) for x in xs)).numpy()

    _, oracle = run()
    plan = ChaosPlan(faults=[
        FaultSpec("crash", stage="a", round=0, worker=1, when="after"),
        FaultSpec("tamper", stage="b", round=0, worker=0, rows=1)])
    p, out = run(chaos=plan, retry=_policy())
    assert not plan.pending()
    want = np.zeros(32, np.float32)
    for x in xs:
        want = want + np.maximum(x * np.float32(1.5), np.float32(0))
    assert np.array_equal(out, oracle) and np.array_equal(out, want)
    assert p.directory.audit.counts()["window_replayed"] == 1


# ----------------------------------------------------- engine interlocks


def test_ft_requires_window_engine():
    p = _build(retry=RetryPolicy())
    with pytest.raises(ValueError, match="window_chunks"):
        p.run(iter([]), window_chunks=1)
    # the tight rekey cadence that clamps the window to 1 is refused too
    tight = pipeline_mod.Pipeline(
        _stages8(pipeline_mod.Stage), SecureStreamConfig(mode="encrypted"),
        directory=KeyDirectory(seed=0, epoch_history=3), window_chunks=4,
        device="cpu")
    with pytest.raises(ValueError, match="epoch_history"):
        tight.run(iter([]), rekey_every_n=3, chaos=ChaosPlan())


def test_fresh_coords_come_from_ingress_edge():
    p = _build()
    before = p.directory.session("edge0").chunks
    counters, epoch = p._ft_fresh_coords(4)
    assert counters == list(range(before, before + 4))
    assert p.directory.session("edge0").chunks == before + 4
    assert epoch == p.directory.epoch
    plain = pipeline_mod.Pipeline(
        _stages8(pipeline_mod.Stage), SecureStreamConfig(mode="plain"),
        window_chunks=4, device="cpu")
    assert plain._ft_fresh_coords(4) is None


@pytest.mark.parametrize("view", [False, True])
def test_apply_tamper_writes_a_copy_equal_to_reference(view):
    """The tamper flips word 0 of the first rows by 0xDEADBEEF, as the
    reference's does, on a copy: the caller's tensor (or the larger
    tensor a window's words are a view of) is unchanged."""
    words = np.random.default_rng(9).integers(0, 2 ** 32, (4, 37),
                                              dtype=np.uint32)
    big = from_numpy(np.concatenate([words, words], axis=1), "cpu")
    t = big[:, 5:42] if view else from_numpy(words, "cpu")
    if view:
        words = to_numpy(t)
    before = t.clone()
    win = SealedWindow(words=t, tags=None, counters=[0, 1, 2, 3],
                       epochs=[0] * 4, meta=(), n_words=37)
    spec = FaultSpec("tamper", rows=2)
    out = ChaosPlan.apply_tamper(spec, win)
    assert torch.equal(t, before) and out.words is not t
    want = np.asarray(JChaosPlan.apply_tamper(
        JFaultSpec("tamper", rows=2),
        j_enclave.SealedWindow(words=jnp.asarray(words), tags=None,
                               counters=[0, 1, 2, 3], epochs=[0] * 4,
                               meta=(), n_words=37)).words)
    assert np.array_equal(to_numpy(out.words), want)
    assert np.array_equal(want[:2, 0], words[:2, 0] ^ np.uint32(0xDEADBEEF))
    assert np.array_equal(want[2:], words[2:])


# ------------------------------------------------------------- DSL verbs


def test_dsl_retry_and_chaos_verbs():
    from repro_torch.dsl import stream
    src = [torch.as_tensor(c) for c in _records()]
    plan = ChaosPlan(faults=[FaultSpec("crash", stage="m", round=0,
                                       worker=0)])

    def job():
        return (stream(src).map("scale_f32", const=2.0, name="m", workers=2)
                .reduce(_sum_reduce, None, name="r")
                .secure("encrypted").window(4).device("cpu"))
    b = job().retry(RetryPolicy(max_attempts=2, sleep=_no_sleep)) \
        .chaos(plan)
    assert b.retry_policy.max_attempts == 2 and b.chaos_plan is plan
    out = b.run()
    assert torch.equal(job().run(), out)
    assert plan.events == [("crash", "m", 0, 0)]
    assert b.pipeline.directory.audit.kind_sequence(
        "worker_failed", "share_retried") == ["worker_failed",
                                              "share_retried"]
    assert job().retry_policy is None and job().chaos_plan is None
    assert isinstance(job().retry().retry_policy, RetryPolicy)


# ---------------------------------------------------------------- ft units


def test_replay_buffer_retain_ack_watermark():
    REGISTRY.reset()
    buf = ReplayBuffer()
    buf.retain("s0", 0, [[1, 2, 3]])
    assert buf.retained_rows() == 3
    assert REGISTRY.get("ft.replay.retained_rows").value == 3
    assert buf.get("s0", 0) == [[1, 2, 3]] and buf.watermark() == -1
    buf.ack("s0", 0)
    assert buf.retained_rows() == 0 and buf.get("s0", 0) is None
    buf.retain("s1", 1, [[1], [2, 3]])
    buf.ack("s1", 1)
    assert buf.watermark() == 0          # min over stages: s0 acked 0


def test_backup_dispatcher_track_and_reissue():
    d = BackupDispatcher(num_workers=3)
    d.track(7, 2)
    assert d.reissue(7) == 0             # the backup goes to the NEXT worker
    assert d.complete(7) is True
    assert d.complete(7) is False and d.duplicates == 1
    assert d.reissue(7) is None          # completed: nothing to reissue
    assert d.backups == 1


def test_retry_policy_backoff_sleeps_through_its_hook():
    """Retries sleep the policy's backoff through ``sleep`` (never the
    real clock here), and the stall cutoff follows the detector, equal to
    the reference's policy and detector on the same times."""
    from repro.ft.straggler import StragglerDetector as JStraggler
    pol = RetryPolicy(backoff_base_s=0.1, backoff_factor=2.0,
                      max_backoff_s=0.3)
    assert [pol.backoff(a) for a in (1, 2, 5)] == \
        pytest.approx([0.1, 0.2, 0.3])
    assert RetryPolicy().backoff(3) == 0.0
    want = _oracle()
    slept = []
    plan = ChaosPlan(faults=[FaultSpec("crash", stage="s1", round=0),
                             FaultSpec("crash", stage="s5", round=1)])
    p = _build(chaos=plan, retry=RetryPolicy(backoff_base_s=0.1,
                                             sleep=slept.append))
    out, _ = _run(p)
    assert np.array_equal(out, want)
    assert slept == pytest.approx([0.1, 0.1])
    det, jdet = StragglerDetector(), JStraggler()
    pol2 = RetryPolicy(min_timeout_s=0.05, timeout_scale=4.0)
    assert pol2.timeout_for(det) == 0.05             # cold: the floor
    times = [0.1, 0.12, 0.09, 0.11, 0.1, 0.5, 0.1, 0.3, 0.1]
    assert [det.observe(t) for t in times] == \
        [jdet.observe(t) for t in times]
    assert pol2.timeout_for(det) == pytest.approx(4.0 * det.mean)
    assert det.mean == jdet.mean and det.var == jdet.var
    assert RetryPolicy(share_timeout_s=1.5).timeout_for(det) == 1.5
