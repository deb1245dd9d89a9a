"""End-to-end secure LM training on the PyTorch port, beside
``secure_lm_train.py``: sealed data pipeline -> train loop -> sealed
checkpoints -> (optional) injected failure + recovery.

On the card every layer's attention is kernel 7 (``attn_impl="flash"``),
which is built for head dim 64: ``--size 20m`` or ``100m``.  ``2m`` has
head dim 32 and runs on the CPU only; on the card it raises through
kernel 7's head-dim check (there is no fallback).

Run:  PYTHONPATH=src python examples/torch_secure_lm_train.py \\
          --size 20m --steps 200
      PYTHONPATH=src python examples/torch_secure_lm_train.py \\
          --size 2m --steps 60 --fail-at 30 --device cpu
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.ft.failures import FailureInjector
from repro_torch.train.trainer import Trainer, TrainerConfig

SIZES = {
    "2m": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
               d_ff=512, vocab_size=2048, head_dim=32),
    "20m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
                d_ff=1536, vocab_size=8192, head_dim=64),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=3072, vocab_size=32000, head_dim=64),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="20m", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a node failure at this step (0=off)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-torch-secure-lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = ModelConfig(arch_id=f"secure-lm-{args.size}", family="dense",
                      tie_embeddings=True, **SIZES[args.size])
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("train", args.seq, args.batch, "train"),
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=20),
        remat="none",
    )

    # deterministic per-step data => exactly-once replay after recovery
    def data_fn(step: int):
        rng = np.random.default_rng(1000 + step)
        # learnable structure: tokens follow a noisy modular sequence
        start = rng.integers(0, cfg.vocab_size, (args.batch, 1))
        ramp = (start + np.arange(args.seq + 1)[None]) % cfg.vocab_size
        noise = rng.integers(0, cfg.vocab_size, ramp.shape)
        keep = rng.random(ramp.shape) < 0.9
        toks = np.where(keep, ramp, noise).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    injector = FailureInjector(schedule={args.fail_at: "node_loss"}) \
        if args.fail_at else None
    trainer = Trainer(
        run, data_fn,
        TrainerConfig(total_steps=args.steps, ckpt_every=25, log_every=10,
                      ckpt_dir=args.ckpt_dir, sealed_ckpt=True,
                      sealed_data=True),
        injector=injector, device=torch.device(args.device))

    print(f"training {cfg.arch_id} on {args.device}: "
          f"{cfg.param_count() / 1e6:.1f}M params, {args.steps} steps, "
          f"sealed data+checkpoints")
    out = trainer.train()
    for h in out["history"]:
        print(f"  step {h['step']:>5}  loss {h['loss']:.4f}  "
              f"{h['sec_per_step'] * 1e3:.0f} ms/step")
    print(f"done: step={out['final_step']} restarts={out['restarts']} "
          f"replayed={out['replayed_steps']} stragglers={out['stragglers']}")


if __name__ == "__main__":
    main()
