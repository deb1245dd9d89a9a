"""Replay-based failover: the sealed ingress replay buffer + the run
context that ties the fault-tolerance pieces together (the port's own
copy of the reference, with the same ``ft.*`` registry names).

The replay buffer is the recovery invariant's anchor: every window's
sealed input parts are RETAINED (still under their directory-reserved
nonce blocks) until the window's single host-side verdict sync has been
folded into the output — only then does ``ack`` release them and the
watermark advance.  Any share whose result is lost (worker crash, stall
loss to a backup, tamper, dropped verdict) is re-executed from these
retained rows, re-sealed under FRESH counter blocks reserved from the
ingress edge, so recovery never reuses a (key, nonce, counter) triple
and the terminal reduce stays bit-identical to the fault-free run.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.ft.chaos import ChaosPlan
from repro_torch.ft.retry import RetryPolicy
from repro_torch.ft.straggler import BackupDispatcher, StragglerDetector
from repro_torch.obs.metrics import REGISTRY


class ReplayBuffer:
    """Sealed ingress rows retained per (stage, round) until acked.

    Windows are retained per stage hop: the rows a stage consumed are
    exactly what a re-execution of that stage's share needs (already
    sealed under the stage's inbound edge key).  ``watermark`` is the
    highest round fully acked at every retaining stage — rows at or
    below it have been garbage-collected.
    """

    def __init__(self):
        self._held: Dict[Tuple[str, int], List] = {}
        self._acked_rounds: Dict[str, int] = {}
        self._gauge = REGISTRY.gauge("ft.replay.retained_rows")

    def retain(self, stage: str, rnd: int, parts: List) -> None:
        self._held[(stage, rnd)] = parts
        self._gauge.set(self.retained_rows())

    def get(self, stage: str, rnd: int) -> Optional[List]:
        return self._held.get((stage, rnd))

    def ack(self, stage: str, rnd: int) -> None:
        """The verdict sync for (stage, round) is folded in: release."""
        self._held.pop((stage, rnd), None)
        prev = self._acked_rounds.get(stage, -1)
        self._acked_rounds[stage] = max(prev, rnd)
        self._gauge.set(self.retained_rows())

    def watermark(self) -> int:
        """Highest round acked by every stage seen so far (GC frontier)."""
        if not self._acked_rounds:
            return -1
        return min(self._acked_rounds.values())

    def retained_rows(self) -> int:
        return sum(sum(len(p) for p in parts)
                   for parts in self._held.values())


@dataclass
class FTContext:
    """Per-run fault-tolerance state, created by the pipeline when retry
    or chaos is enabled.  Holds the policy, the (optional) fault plan,
    the replay buffer, per-stage straggler detectors + backup
    dispatchers, the set of workers declared dead, the ft.* counters
    the monitor exposes, and by (stage, round) the shares dispatched and
    the executions (open -> op -> seal, one launch of the window hop
    each) run: a share's first, and each retry, failover, backup and
    replay."""
    policy: RetryPolicy = field(default_factory=RetryPolicy)
    chaos: Optional[ChaosPlan] = None
    buffer: ReplayBuffer = field(default_factory=ReplayBuffer)
    detectors: Dict[str, StragglerDetector] = field(default_factory=dict)
    dispatchers: Dict[str, BackupDispatcher] = field(default_factory=dict)
    dead: Set[Tuple[str, int]] = field(default_factory=set)
    shares: Counter = field(default_factory=Counter)
    executions: Counter = field(default_factory=Counter)
    _share_seq: int = 0

    def __post_init__(self):
        self.retries = REGISTRY.counter("ft.retries")
        self.failovers = REGISTRY.counter("ft.failovers")
        self.backups = REGISTRY.counter("ft.backups")
        self.replays = REGISTRY.counter("ft.replays")
        self.worker_failures = REGISTRY.counter("ft.worker_failures")
        self.enroll_failures = REGISTRY.counter("ft.enroll_failures")

    def detector(self, stage: str) -> StragglerDetector:
        if stage not in self.detectors:
            self.detectors[stage] = StragglerDetector()
        return self.detectors[stage]

    def dispatcher(self, stage: str, num_workers: int) -> BackupDispatcher:
        d = self.dispatchers.get(stage)
        if d is None:
            d = BackupDispatcher(num_workers=num_workers)
            self.dispatchers[stage] = d
        else:
            d.num_workers = max(d.num_workers, num_workers)
        return d

    def next_share_id(self) -> int:
        sid = self._share_seq
        self._share_seq += 1
        return sid

    def mark_dead(self, stage: str, worker: int) -> None:
        self.dead.add((stage, worker))

    def is_dead(self, stage: str, worker: int) -> bool:
        return (stage, worker) in self.dead
