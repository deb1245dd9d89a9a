"""repro_torch.ft — fault tolerance for the window engine.

Per-share retry, failover and speculative backup (:mod:`.retry`,
:mod:`.straggler`), replay from retained sealed rows (:mod:`.recovery`)
and seeded fault injection (:mod:`.chaos`), consulted by
:class:`repro_torch.core.pipeline.Pipeline` when a ``retry=`` policy or a
``chaos=`` plan is given.
"""
from repro_torch.ft.chaos import ChaosPlan, FaultSpec
from repro_torch.ft.recovery import FTContext, ReplayBuffer
from repro_torch.ft.retry import RetryPolicy
from repro_torch.ft.straggler import BackupDispatcher, StragglerDetector

__all__ = ["ChaosPlan", "FaultSpec", "FTContext", "ReplayBuffer",
           "RetryPolicy", "BackupDispatcher", "StragglerDetector"]
