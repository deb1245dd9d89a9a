"""Failure handling: detection/simulation + checkpoint-restart recovery.

Port of ``repro/ft/failures.py`` (it imports nothing of jax there
either; the port keeps its own copy).

On a real fleet, node failures surface as collective timeouts or device
errors; the recovery primitive is identical either way: restore the last
sealed checkpoint and continue (possibly on a *different* mesh — elastic
restore, repro_torch.ckpt).  This module provides the policy layer:

* ``FailureInjector`` — deterministic fault schedule for tests/examples
  (step -> kind), standing in for real device loss on CPU;
* ``run_with_recovery`` — the supervisor loop: run the step function,
  on failure restore from checkpoint and replay the data stream to the
  restored step (streams are counter-addressed, so replay = fast-forward
  of the chunk counter — the SecureStreams nonce discipline gives
  exactly-once semantics for free).

Revocation (repro_torch.attest) is handled like a failed node: when a failure
names a worker (``worker_id`` on the exception, or an injector kind of
``"revoked:<id>"``), the supervisor quarantines it in the KeyDirectory —
its quotes stop verifying, its sessions are torn down — then runs the
``reestablish`` hook (re-handshake on the surviving set) before the
checkpoint restore.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class SimulatedFailure(RuntimeError):
    def __init__(self, kind: str, step: int):
        super().__init__(f"simulated {kind} at step {step}")
        self.kind = kind
        self.step = step
        # "revoked:<worker_id>" marks a compromised-worker eviction; the
        # supervisor treats it as a failed node + revocation.
        self.worker_id = kind.split(":", 1)[1] \
            if kind.startswith("revoked:") else None


@dataclass
class FailureInjector:
    schedule: Dict[int, str] = field(default_factory=dict)  # step -> kind
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        kind = self.schedule.get(step)
        if kind and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(kind, step)


@dataclass
class RecoveryReport:
    restarts: int = 0
    failures: List[Tuple[int, str]] = field(default_factory=list)
    replayed_steps: int = 0
    final_step: int = -1
    revoked_workers: List[str] = field(default_factory=list)


def run_with_recovery(
    *,
    total_steps: int,
    run_steps: Callable[[int, int], int],
    # run_steps(start_step, end_step) -> last completed step; raises on fail
    restore: Callable[[], int],
    # restore() -> step to resume from (restores model state internally)
    max_restarts: int = 8,
    directory=None,
    # repro_torch.attest KeyDirectory: failures that name a worker_id revoke it
    reestablish: Optional[Callable[[Any], None]] = None,
    # reestablish(directory): re-handshake sessions on the surviving set
) -> RecoveryReport:
    """Supervisor loop: keep running until total_steps or restart budget.

    A failure carrying a ``worker_id`` (e.g. an injector kind of
    ``"revoked:<id>"`` or repro_torch.attest's RevokedWorkerError) is a
    compromised worker, not just a crashed one: it is revoked in
    ``directory`` (quarantined + its sessions dropped) and
    ``reestablish`` runs before the restore so the survivors re-handshake
    — then recovery proceeds exactly like a node loss.
    """
    report = RecoveryReport()
    step = restore()
    while step < total_steps:
        resumed_from = step          # last state-consistent step
        try:
            step = run_steps(step, total_steps)
        except Exception as e:  # noqa: BLE001 — any failure -> recover
            report.restarts += 1
            # honest failure accounting: trust the exception's own step
            # when it carries one; otherwise the best known lower bound
            # is the step this attempt RESUMED from, not the loop
            # variable (which may alias a later partial advance)
            failed_at = getattr(e, "step", None)
            if failed_at is None:
                failed_at = resumed_from
            report.failures.append((failed_at, repr(e)))
            if report.restarts > max_restarts:
                raise RuntimeError(
                    f"restart budget exhausted after {report.restarts}") from e
            wid = getattr(e, "worker_id", None)
            if wid is not None and directory is not None:
                from repro_torch.attest.directory import KeyDirectoryError
                if wid not in directory.policy.revoked:
                    try:
                        directory.revoke(wid)
                    except KeyDirectoryError:
                        wid = None        # names no enrolled worker
                if wid is not None:
                    report.revoked_workers.append(wid)
                    if reestablish is not None:
                        reestablish(directory)
            resumed = restore()
            if resumed > failed_at:
                # a checkpoint from AFTER the failure step means restore
                # did not rewind to a state-consistent point (stale or
                # foreign checkpoint directory) — continuing would skip
                # data; replaying from it would double-fold.  Refuse.
                raise RuntimeError(
                    f"restore() resumed at step {resumed}, past the "
                    f"failure at step {failed_at} — the checkpoint does "
                    f"not precede the failure, recovery cannot replay "
                    f"exactly") from e
            report.replayed_steps += failed_at - resumed
            step = resumed
    report.final_step = step
    return report
