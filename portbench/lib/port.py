"""The program's side of a run: its configuration object built from a
configuration file, and the device it runs on."""
from __future__ import annotations

import torch

from portbench.lib import spec


def model_config(name: str, m: dict):
    """The port's ``ModelConfig`` of the sizes ``m``; its parameter layout
    must be the one the harness draws."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import api
    cfg = ModelConfig(arch_id=name, **{k: m[k] for k in spec.MODEL_KEYS})
    got = {k: tuple(t.shape)
           for k, t in spec.leaves(api.abstract_params(cfg))}
    want = {".".join(l.path): l.shape for l in spec.layout(m)}
    if got != want:
        raise RuntimeError(
            f"the port's parameter layout differs from the harness's: "
            f"{sorted(set(got.items()) ^ set(want.items()))}")
    return cfg


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if is_cuda(device) else 0


def free(device) -> None:
    if is_cuda(device):
        torch.cuda.empty_cache()
