"""Deterministic fault injection for the window engine.

The port's own copy of the reference plan; only the tamper's body is
torch (u32 words are int32-carried, :mod:`repro_torch.u32`).

A ``ChaosPlan`` is a seed-scheduled list of ``FaultSpec``s with hook
points at every engine boundary the pipeline exposes:

* ``crash``        — a worker is lost before (or after) executing its
                     share of a window; ``fatal`` crashes remove the
                     worker for the rest of the run, transient ones
                     make exactly one dispatch disappear.
* ``stall``        — a worker's share takes ``seconds`` longer than it
                     should; the straggler detector + backup dispatcher
                     decide whether a speculative backup wins.
* ``tamper``       — the ciphertext of a share is flipped in flight
                     (MAC failure downstream; the replay buffer must
                     re-execute from the retained clean rows).
* ``drop_verdict`` — the host-side MAC verdict sync for a share is
                     lost; the engine must treat the share as
                     unverified and replay it.
* ``enroll_fail``  — a live enrollment (spare admission) fails its
                     attestation handshake; injected through
                     ``KeyDirectory.admission_interceptor`` so the
                     rejection takes the REAL quote_rejected audit
                     path.

The plan is consulted by ``core.pipeline`` at each hop, and every poll
consumes at most one matching un-fired spec — so a given (seed, plan)
replays bit-for-bit: same faults, same rounds, same workers, every run.
``replay()`` resets the fired flags for a second identical pass.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("crash", "stall", "tamper", "drop_verdict", "enroll_fail")

#: the tamper's XOR pattern 0xDEADBEEF as the int32 that carries its bits
#: (``torch.tensor(0xDEADBEEF, dtype=torch.int32)`` would overflow)
TAMPER_FLIP = int(np.uint32(0xDEADBEEF).view(np.int32))


@dataclass
class FaultSpec:
    """One scheduled fault.  ``stage``/``round``/``worker`` address the
    hook point; fields beyond that parameterize the fault kind."""
    kind: str
    stage: str = ""
    round: int = 0
    worker: int = 0
    when: str = "before"      # crash: "before" (share lost) / "after"
                              # (share computed, result lost)
    fatal: bool = False       # crash: worker never comes back
    rows: int = 1             # tamper: number of leading rows to corrupt
    seconds: float = 0.0      # stall: artificial extra latency observed
    fired: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclass
class ChaosPlan:
    """A replayable fault schedule.  ``events`` records each fault as it
    fires — (kind, stage, round, worker) — in firing order, so a test
    can assert exactly-once audit coverage against it."""
    faults: List[FaultSpec] = field(default_factory=list)
    seed: Optional[int] = None
    events: List[Tuple[str, str, int, int]] = field(default_factory=list)

    # ---- construction ----------------------------------------------------
    @classmethod
    def seeded(cls, seed: int, stage_workers: Sequence[Tuple[str, int]], *,
               rounds: int = 3, n_faults: int = 4,
               kinds: Sequence[str] = ("crash", "stall", "tamper",
                                       "drop_verdict")) -> "ChaosPlan":
        """Deterministically generate ``n_faults`` faults over the given
        ``(stage_name, n_workers)`` topology.  Same seed -> same plan.
        Fault addresses (stage, round, worker) are kept DISTINCT so each
        injected fault has an unambiguous exactly-once audit footprint
        (two faults on one share would entangle their recovery paths)."""
        rng = random.Random(f"repro-chaos-{seed}")
        faults = []
        used = set()
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            for _try in range(64):
                stage, nw = rng.choice(list(stage_workers))
                addr = (stage, rng.randrange(rounds),
                        rng.randrange(max(nw, 1)))
                if addr not in used:
                    break
            else:
                continue                   # topology saturated: skip
            used.add(addr)
            spec = FaultSpec(
                kind=kind, stage=addr[0], round=addr[1], worker=addr[2],
                when=rng.choice(("before", "after")) if kind == "crash"
                else "before",
                fatal=(kind == "crash" and rng.random() < 0.25),
                rows=rng.randrange(1, 3),
                seconds=rng.uniform(0.5, 2.0) if kind == "stall" else 0.0,
            )
            faults.append(spec)
        return cls(faults=faults, seed=seed)

    # ---- engine hook points ----------------------------------------------
    def _take(self, kind: str, stage: str, rnd: int,
              worker: int) -> Optional[FaultSpec]:
        for f in self.faults:
            if (not f.fired and f.kind == kind and f.stage == stage
                    and f.round == rnd and f.worker == worker):
                f.fired = True
                self.events.append((kind, stage, rnd, worker))
                return f
        return None

    def crash_for(self, stage: str, rnd: int, worker: int):
        return self._take("crash", stage, rnd, worker)

    def stall_for(self, stage: str, rnd: int, worker: int):
        return self._take("stall", stage, rnd, worker)

    def tamper_for(self, stage: str, rnd: int, worker: int):
        return self._take("tamper", stage, rnd, worker)

    def drop_verdict_for(self, stage: str, rnd: int, worker: int):
        return self._take("drop_verdict", stage, rnd, worker)

    def enroll_failure(self, worker_id: str) -> Optional[str]:
        """Admission-interceptor hook: a pending ``enroll_fail`` spec
        rejects the next live enrollment, whoever it names."""
        for f in self.faults:
            if not f.fired and f.kind == "enroll_fail":
                f.fired = True
                self.events.append(("enroll_fail", worker_id, -1, -1))
                return "chaos-injected enrollment failure"
        return None

    # ---- fault application -----------------------------------------------
    @staticmethod
    def apply_tamper(spec: FaultSpec, win):
        """Return a tampered COPY of ``win`` (the caller's retained clean
        rows must stay clean for the replay path): flip word 0 of the
        first ``spec.rows`` rows.  A window's words may be the caller's
        tensor or a view of a larger one, so the flip writes a clone."""
        k = min(max(spec.rows, 1), win.words.shape[0])
        words = win.words.clone()
        words[:k, 0] ^= TAMPER_FLIP
        return replace(win, words=words)

    # ---- replay ----------------------------------------------------------
    def replay(self) -> "ChaosPlan":
        """Reset fired flags + event log so the SAME schedule re-fires
        identically on a second run (bit-for-bit replayability)."""
        for f in self.faults:
            f.fired = False
        self.events.clear()
        return self

    def pending(self) -> List[FaultSpec]:
        return [f for f in self.faults if not f.fired]
