"""Learning-rate schedules (pure functions of the step counter), port of
``repro/optim/schedules.py``.  The step enters as an integer and every
quantity is f32, as the reference's jnp arithmetic is: the result is a
0-d f32 tensor on the CPU, which multiplies tensors on any device as a
scalar."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int = 100_000, floor: float = 0.1
                  ) -> torch.Tensor:
    f32 = torch.float32
    step = torch.as_tensor(step).to(device="cpu", dtype=f32)
    warm = peak_lr * torch.minimum(step / max(warmup_steps, 1),
                                   torch.tensor(1.0, dtype=f32))
    prog = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
