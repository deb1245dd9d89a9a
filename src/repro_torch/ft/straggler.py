"""Straggler mitigation (the port's own copy of the reference module).

Two mechanisms, mirroring production practice:

* **Detection**: per-step wall-time EWMA + robust z-score; a worker (or
  the whole step, in SPMD) flagging persistently above ``threshold`` sigma
  is a straggler.  In SPMD the step time is the max over devices, so
  detection at the step level catches any slow device.
* **Backup dispatch** (input stages): the SecureStreams router re-issues
  the straggler's pending chunk to the least-loaded peer worker; because
  chunks are counter-addressed and idempotent (AEAD nonce = counter),
  duplicated completions deduplicate naturally — the reactive-router
  version of MapReduce speculative execution.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class StragglerDetector:
    alpha: float = 0.1           # EWMA smoothing
    threshold: float = 3.0       # robust z threshold
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0

    def observe(self, seconds: float) -> bool:
        """Feed one step time; True if this step is a straggler outlier."""
        self.n += 1
        if self.n <= self.warmup:
            # prime the statistics
            d = seconds - self.mean
            self.mean += d / self.n
            self.var += d * (seconds - self.mean)
            return False
        std = math.sqrt(max(self.var / max(self.n - 1, 1), 1e-12))
        z = (seconds - self.mean) / max(std, 1e-9)
        # robust: need BOTH a z-outlier and a material relative slowdown
        is_straggler = z > self.threshold and seconds > 1.5 * self.mean
        if not is_straggler:
            # only fold non-outliers into the baseline
            self.mean = (1 - self.alpha) * self.mean + self.alpha * seconds
            self.var = (1 - self.alpha) * self.var + self.alpha * (
                seconds - self.mean) ** 2
        return is_straggler


@dataclass
class BackupDispatcher:
    """Speculative re-execution for input-stage chunks."""
    num_workers: int
    inflight: Dict[int, int] = field(default_factory=dict)   # chunk -> worker
    completed: set = field(default_factory=set)
    duplicates: int = 0
    backups: int = 0

    def assign(self, chunk_id: int) -> int:
        w = chunk_id % self.num_workers
        self.inflight[chunk_id] = w
        return w

    def track(self, chunk_id: int, worker: int) -> int:
        """Record an externally-chosen assignment (the window engine does
        its own round-robin; the dispatcher still needs the mapping so
        ``reissue`` picks a DIFFERENT worker for the backup copy)."""
        self.inflight[chunk_id] = worker
        return worker

    def reissue(self, chunk_id: int) -> Optional[int]:
        """Straggling chunk: send a backup copy to the next worker."""
        if chunk_id in self.completed:
            return None
        w = (self.inflight.get(chunk_id, chunk_id) + 1) % self.num_workers
        self.backups += 1
        return w

    def complete(self, chunk_id: int) -> bool:
        """Returns True the first time a chunk completes (dedup)."""
        if chunk_id in self.completed:
            self.duplicates += 1
            return False
        self.completed.add(chunk_id)
        self.inflight.pop(chunk_id, None)
        return True
