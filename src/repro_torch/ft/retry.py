"""Per-share retry policy: bounded attempts, exponential backoff, and a
straggler-fed share timeout (the port's own copy of the reference).

The unit of retry is one worker's batched open -> op -> seal share of a
window (the engine's unit of device work).  A retried share must NEVER
re-seal under a (key, nonce, counter) triple that was already spent on
the outbound key — the engine reserves a FRESH counter block from the
ingress edge for every re-execution, so the policy here is purely about
scheduling: how many attempts, how long to wait between them, and when
a slow share should lose to a speculative backup.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.ft.straggler import StragglerDetector


@dataclass
class RetryPolicy:
    """Scheduling knobs for per-share retry / failover / backup.

    ``share_timeout_s`` pins the stall cutoff; when None, the cutoff is
    fed by the per-stage ``StragglerDetector`` (``timeout_scale`` x the
    observed mean share time once the detector is warmed up).
    """
    max_attempts: int = 3          # total tries on the SAME worker
    backoff_base_s: float = 0.0    # first retry delay (0 = immediate: the
                                   # schedule is deterministic either way)
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    deadline_s: Optional[float] = None   # wall-clock budget per share
    share_timeout_s: Optional[float] = None
    timeout_scale: float = 4.0
    min_timeout_s: float = 0.05
    replay_mac_failures: bool = True     # tampered rows re-run from the
                                         # replay buffer instead of dropping
    failover: bool = True                # move a dead share to a survivor
    enroll_spare: bool = True            # no survivors -> enroll a spare
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based)."""
        if self.backoff_base_s <= 0.0:
            return 0.0
        d = self.backoff_base_s * (self.backoff_factor ** (attempt - 1))
        return min(d, self.max_backoff_s)

    def timeout_for(self, detector: Optional[StragglerDetector]) -> float:
        """Stall cutoff for one share, in seconds."""
        if self.share_timeout_s is not None:
            return self.share_timeout_s
        if detector is not None and detector.n >= detector.warmup:
            return max(self.min_timeout_s,
                       self.timeout_scale * detector.mean)
        return self.min_timeout_s
