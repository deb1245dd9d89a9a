"""Trainer: the supervised loop tying everything together (port of
``repro/train/trainer.py``).

data (sealed SecureStreams source) -> train step -> sealed checkpoints
every N steps -> failure recovery (checkpoint-restart) -> straggler
detection on step times.  This is the end-to-end loop used by
``examples/torch_secure_lm_train.py``.

On the card each step's batch is sealed and opened by the per-chunk AEAD
(``ingress``/``egress("encrypted", ...)``: kernels 4 and 5) under the
session key of an attested ``KeyDirectory`` edge, the step runs kernel 7
in every layer (``attn_impl="flash"``), and a checkpoint is sealed by one
batched AEAD call (kernels 1 and 2).  The optimizer builds new tensors
each step; the step-0 snapshot is a copy all the same, so a failure
before the first checkpoint replays from the initial state.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.attest.directory import KeyDirectory
from repro_torch.attest.measure import IO_ENDPOINT
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.core.enclave import egress, ingress
from repro_torch.ft.failures import FailureInjector, run_with_recovery
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.models import api as model_api
from repro_torch.optim.optimizers import tree_map
from repro_torch.train.steps import make_train_step

Params = Any


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro-torch-ckpt")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    sealed_ckpt: bool = True
    sealed_data: bool = True
    log_every: int = 10
    seed: int = 0


def _copy(tree: Params) -> Params:
    return tree_map(lambda t: t.clone(), tree)


def _structure(tree: Params) -> Params:
    """The tree's structure with empty leaves (a restore template)."""
    return tree_map(lambda t: t.new_empty(0), tree)


class Trainer:
    """``data_fn(step) -> {name: numpy array}`` must be deterministic
    (replay).  The parameters are drawn from ``run.seed`` on ``device``.
    There is no ``MeshContext`` argument: the port trains on one card."""

    def __init__(self, run: RunConfig,
                 data_fn: Callable[[int], Dict[str, np.ndarray]],
                 tcfg: Optional[TrainerConfig] = None,
                 injector: Optional[FailureInjector] = None, *,
                 device="cuda"):
        self.run = run
        self.tcfg = tcfg if tcfg is not None else TrainerConfig()
        self.device = torch.device(device)
        self.data_fn = data_fn
        self.injector = injector
        self.detector = StragglerDetector()
        self.history: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []

        self._step_fn, self.opt = make_train_step(run)
        # Attested data channel: the source and the trainer handshake via
        # the KeyDirectory; the session key seals every batch.  One
        # directory per trainer = one trust domain; a restart reuses it,
        # so replayed chunks re-open under the same key.
        self.directory = KeyDirectory(seed=self.tcfg.seed)
        self.directory.enroll("io/data-source", IO_ENDPOINT, allow=True)
        self.directory.enroll("trainer", IO_ENDPOINT, allow=True)
        self._data_key = self.directory.establish(
            "train-data", "io/data-source", "trainer", stage_id=0)

        gen = torch.Generator(device=self.device).manual_seed(run.seed)
        self.params = model_api.init_params(run.model, gen, self.device)
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        # Step-0 snapshot: restore() must rewind to a state-consistent
        # point even when NO checkpoint exists yet (a failure before the
        # first save).  Real copies: a failed attempt's partial progress
        # must not leak into the replay.
        self._init_params = _copy(self.params)
        self._init_opt_state = _copy(self.opt_state)

    # ------------------------------------------------------------ data path

    def _sealed_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Fetch the step's batch through the secure ingest path."""
        raw = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in self.data_fn(step).items()}
        if not self.tcfg.sealed_data:
            return raw
        out = {}
        for i, (k, v) in enumerate(sorted(raw.items())):
            chunk = ingress("encrypted", self._data_key, step * 16 + i, v)
            x, ok = egress("encrypted", self._data_key, chunk)
            if not bool(ok):
                raise RuntimeError(f"data chunk MAC failure at step {step}")
            out[k] = x
        return out

    # ------------------------------------------------------------- recovery

    def save(self) -> None:
        ckpt.save(self.tcfg.ckpt_dir, self.step, self.params, self.opt_state,
                  sealed=self.tcfg.sealed_ckpt, seed=self.tcfg.seed,
                  extra={"arch": self.run.model.arch_id}, device=self.device)

    def restore(self) -> int:
        # the failed attempt's state goes before the restored one comes:
        # a model's parameters and optimizer state would otherwise be
        # held twice (12.4 GB for llama3.2-1b with AdamW)
        params_like, opt_like = _structure(self.params), \
            _structure(self.opt_state)
        self.params = self.opt_state = None
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            # no checkpoint yet: rewind to the step-0 snapshot — the
            # failed attempt's partial progress must not leak into the
            # replay (recovered output == uninterrupted output, exactly)
            self.params = _copy(self._init_params)
            self.opt_state = _copy(self._init_opt_state)
            self.step = 0
            return 0
        step, params, opt_state = ckpt.restore(
            self.tcfg.ckpt_dir, last, seed=self.tcfg.seed,
            params_like=params_like, opt_like=opt_like, device=self.device)
        self.params, self.opt_state = params, opt_state
        self.step = step
        return step

    # ----------------------------------------------------------------- loop

    def run_steps(self, start: int, end: int) -> int:
        for s in range(start, end):
            if self.injector is not None:
                self.injector.maybe_fail(s)
            t0 = time.perf_counter()
            batch = self._sealed_batch(s)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, s)
            loss = float(metrics.get("loss", float("nan")))
            dt = time.perf_counter() - t0
            if self.detector.observe(dt):
                self.straggler_steps.append(s)
            self.step = s + 1
            if self.step % self.tcfg.log_every == 0:
                self.history.append({"step": self.step, "loss": loss,
                                     "sec_per_step": dt})
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
        return self.step

    def train(self) -> Dict[str, Any]:
        report = run_with_recovery(
            total_steps=self.tcfg.total_steps,
            run_steps=self.run_steps,
            restore=self.restore,
        )
        self.save()
        return {
            "final_step": report.final_step,
            "restarts": report.restarts,
            "replayed_steps": report.replayed_steps,
            "history": self.history,
            "stragglers": self.straggler_steps,
        }
