"""The sealed-training driver: each step's batch (tokens, labels and a
front end's frames) is sealed by the data source and opened by the
trainer under an attested session key, then one AdamW step of the port
runs on it.

Set-up draws the weights, builds the step and its optimizer state, and
runs the first :data:`CHECKED_STEPS` steps (from step 0) through the
window's own call, each on a batch of its own; the window goes on with
the same object until ``seconds`` have passed and the step in flight has
ended.  Those first steps are what the reference follows: their losses,
the first step's clipped gradient (read back from AdamW's first moment,
which is (1 - beta1) times it after one step from zero) and the
parameters' change over them.

With ``control`` the check reads, in the program's place, the reference
over the same steps computed one precision below (``"fp8"``) or with a
fault planted in its input (``"half_batch"``: each batch's second half
left out, the mean taken over the rest).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from portbench.lib import check, port, spec
from portbench.lib.trace import record

#: the end-to-end metrics a training cell reports, beside ``setup_s``
END_TO_END = ("train_tokens_per_s",)
#: the steps the reference follows
CHECKED_STEPS = 3
#: the steps a traced run traces after its window (in each of its passes)
TRACED_STEPS = 2
#: the first gradient's distance is read on every STRIDE-th element of a
#: leaf (musicgen-selfattn-2.4b: 152 M of 2.4 G), kept on the host: the whole
#: gradient's copy would add ~7 s to every run's set-up
STRIDE = 16
#: the controls a training cell reads in the program's place: the
#: reference's keyword arguments for each
CONTROLS = {"fp8": lambda: {"fp8": True},
            "half_batch": lambda: {"batch_fn": half_batch}}
#: the optimizer settings of a configuration file the port takes
OPTIMIZER_KEYS = ("name", "lr", "weight_decay", "beta1", "beta2", "eps",
                  "grad_clip", "warmup_steps")


class Trainer:
    """The program's training path for one configuration."""

    def __init__(self, name: str, m: dict, opt: dict, traffic: dict,
                 weights: dict) -> None:
        from repro_torch.attest.directory import KeyDirectory
        from repro_torch.attest.measure import IO_ENDPOINT
        from repro_torch.configs.base import (OptimizerConfig, RunConfig,
                                              ShapeConfig)
        from repro_torch.train.steps import make_train_step
        B, S = traffic["batch"], traffic["seq_len"]
        run = RunConfig(
            model=port.model_config(name, m),
            shape=ShapeConfig("portbench", S, B, "train"),
            optimizer=OptimizerConfig(**{k: opt[k] for k in OPTIMIZER_KEYS}),
            remat=traffic["remat"])
        self.step_fn, optimizer = make_train_step(run)
        directory = KeyDirectory(seed=0)
        directory.enroll("io/data-source", IO_ENDPOINT, allow=True)
        directory.enroll("trainer", IO_ENDPOINT, allow=True)
        self.key = directory.establish("train-data", "io/data-source",
                                       "trainer", stage_id=0)
        self.params = weights
        self.state = optimizer.init(weights)
        self.device = weights["embed"].device

    def step(self, batch: Dict[str, torch.Tensor], n: int, spans: Dict):
        """Seal and open every array of step ``n``'s batch, then step ->
        (the loss on the device, the opened batch)."""
        from repro_torch.core.enclave import egress, ingress
        from torch.profiler import record_function
        port.sync(self.device)        # the step before has ended
        t0 = time.perf_counter()
        opened = {}
        with record_function("portbench.seal_open"):
            for i, (k, v) in enumerate(sorted(batch.items())):
                chunk = ingress("encrypted", self.key, n * 16 + i, v)
                x, ok = egress("encrypted", self.key, chunk)
                if not bool(ok):
                    raise RuntimeError(f"data chunk MAC failure at step {n}")
                opened[k] = x
        spans.setdefault("seal_open", []).append(time.perf_counter() - t0)
        with record_function("portbench.train_step"):
            self.params, self.state, metrics = self.step_fn(
                self.params, self.state, opened, n)
        return metrics["loss"], opened


class Checked:
    """What the checked steps left for the check: their losses, the first
    step's clipped gradient (on the host) and its norms, the parameters'
    change norms over them, each step's opened batch."""

    def __init__(self, losses, first_grads, grad_norms, changes, opened):
        self.losses, self.first_grads = losses, first_grads
        self.grad_norms, self.changes = grad_norms, changes
        self.opened = opened

    def distance_to(self, into: Dict[str, float]):
        """A ``first_grad`` hook of the reference: |this side's first
        gradient - its| of each leaf, from their :func:`sampled` elements
        (scaled to the whole leaf), into ``into``."""
        def hook(k, g):
            sub = sampled(g)
            into[k] = float((self.first_grads[k].to(g.device) - sub).norm()
                            * (g.numel() / sub.numel()) ** 0.5)
        return hook


def half_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The fault: the second half of the batch's rows left out."""
    return {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}


def sampled(g: torch.Tensor) -> torch.Tensor:
    """Every :data:`STRIDE`-th element of a leaf."""
    return g.reshape(-1)[::STRIDE]


def change_norms(params: dict, start: dict) -> Dict[str, float]:
    """|params - start| of each leaf, a layer of a stacked leaf at a
    time."""
    out = {}
    for (k, p), (_, s) in zip(spec.leaves(params), spec.leaves(start)):
        rows = range(p.shape[0]) if p.dim() == 3 else [slice(None)]
        out[k] = float(torch.stack([(p[r].float() - s[r].float()).norm()
                                    for r in rows]).norm())
    return out


def first_steps(trainer: Trainer, m: dict, traffic: dict, opt: dict,
                seed: int, device) -> Checked:
    """The checked steps, through the window's own call."""
    B, S = traffic["batch"], traffic["seq_len"]
    losses, opened = [], []
    for n in range(CHECKED_STEPS):
        loss, got = trainer.step(spec.train_batch(m, seed, n, B, S, device),
                                 n, {})
        losses.append(float(loss))
        opened.append(got)
        if n == 0:
            first_grads, grad_norms = {}, {}
            for k, t in spec.leaves(trainer.state["m"]):
                g = t / (1 - opt["beta1"])
                grad_norms[k] = float(g.norm())
                first_grads[k] = sampled(g).cpu()
                del g
    changes = change_norms(trainer.params, spec.make_weights(m, seed, device))
    return Checked(losses, first_grads, grad_norms, changes, opened)


def drive(name: str, cfg: dict, traffic: dict, *, seed: int, seconds: float,
          trace: bool, device, control: Optional[str] = None) -> dict:
    from repro_torch.kernels import build
    m, opt = spec.model(cfg), cfg["optimizer"]
    if control is not None and control not in CONTROLS:
        raise ValueError(f"a training cell has no control {control!r}")
    B, S = traffic["batch"], traffic["seq_len"]
    trainer = Trainer(name, m, opt, traffic, spec.make_weights(m, seed,
                                                               device))
    checked = first_steps(trainer, m, traffic, opt, seed, device)
    opened = checked.opened

    spans: Dict[str, List[float]] = {}
    build.reset_launch_counts()
    port.sync(device)
    n = CHECKED_STEPS
    t0 = time.perf_counter()
    while True:
        opened.append(trainer.step(spec.train_batch(m, seed, n, B, S, device),
                                   n, spans)[1])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    port.sync(device)
    window_s = time.perf_counter() - t0
    steps = n - CHECKED_STEPS
    launches = build.launch_counts()
    out = {"t0": t0, "window_s": window_s, "work": [(B, S)] * steps,
           "spans": spans, "memory_peak_bytes": port.peak_bytes(device),
           "attempted": steps, "failed": 0,
           "e2e": {"train_tokens_per_s": steps * B * S / window_s},
           "notes": {"steps": steps, "checked_losses": checked.losses,
                     "launches_a_step": {k: v / steps for k, v in
                                         launches.items() if v}}}
    if trace:
        def work(p):
            for j in range(n + p * TRACED_STEPS, n + (p + 1) * TRACED_STEPS):
                trainer.step(spec.train_batch(m, seed, j, B, S, device), j,
                             {})
        out["trace"] = record(work)
        out["traced_work"] = [(B, S)] * TRACED_STEPS
    del trainer
    port.free(device)
    mismatches = sum(
        int(any(not torch.equal(v, got[k]) for k, v in
                spec.train_batch(m, seed, j, B, S, device).items()))
        for j, got in enumerate(opened))
    del opened
    checked.opened = []
    nums, info = readings(*judge(m, opt, traffic, seed, device, checked,
                                 control))
    out["readings"] = {"roundtrip_mismatches": float(mismatches), **nums}
    out["check_info"] = info
    return out


def reference(m, opt, traffic, seed, device, *, fp8=False,
              batch_fn=lambda b: b, first_grad=None) -> dict:
    """The reference over the checked steps, from the same weights and
    batches (each through ``batch_fn``: a fault planted in the input):
    the family module's ``train``."""
    B, S = traffic["batch"], traffic["seq_len"]
    batches = [batch_fn(spec.train_batch(m, seed, k, B, S, device))
               for k in range(CHECKED_STEPS)]
    return spec.family(m).train(m, opt, spec.make_weights(m, seed, device),
                                batches, fp8=fp8, first_grad=first_grad)


def judge(m, opt, traffic, seed, device, checked: Checked,
          control: Optional[str] = None):
    """The reference over the checked steps -> (the side's losses, first
    gradient norms, change norms and first gradient distances of each
    leaf, the reference's readings).  The side is the program, or with
    ``control`` the reference computed as :data:`CONTROLS` says."""
    dist: Dict[str, float] = {}
    if control is None:
        ref = reference(m, opt, traffic, seed, device,
                        first_grad=checked.distance_to(dist))
        return (checked.losses, checked.grad_norms, checked.changes,
                dist, ref)
    kept: Dict[str, torch.Tensor] = {}
    ref = reference(m, opt, traffic, seed, device, first_grad=lambda k, g:
                    kept.__setitem__(k, sampled(g).cpu()))
    ref_side = Checked(ref["loss"], kept, ref["grad_norms"],
                       ref["change_norms"], [])
    side = reference(m, opt, traffic, seed, device,
                     first_grad=ref_side.distance_to(dist),
                     **CONTROLS[control]())
    return (side["loss"], side["grad_norms"], side["change_norms"], dist,
            ref)


def readings(losses, grads, changes, grad_dist, ref):
    """One side's numbers against the reference: the checked steps'
    losses (the widest gap), and by the worst leaf the first clipped
    gradient's norm, its distance to the reference's (the norm of the
    difference) and the change's norm, this over the leaves the reference
    moves by more than round-off."""
    moved = check.moved_leaves(ref["grad_norms"])
    gaps = [abs(a - b) for a, b in zip(losses, ref["loss"])]
    g_gap, g_at = check.leaf_gap(grads, ref["grad_norms"])
    d_gap, d_at = check.leaf_distance(grad_dist, ref["grad_norms"])
    c_gap, c_at = check.leaf_gap(changes, ref["change_norms"], keep=moved)
    return ({"loss_gap": max(gaps), "grad_norm_gap": g_gap,
             "grad_rel_l2": d_gap, "change_norm_gap": c_gap},
            {"grad_worst_leaf": g_at, "grad_distance_worst_leaf": d_at,
             "change_worst_leaf": c_at, "ref_losses": ref["loss"],
             "leaves_left_out": sorted(set(ref["grad_norms"]) - set(moved))})
