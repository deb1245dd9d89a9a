"""The program's side of a run: its configuration object built from a
configuration file, and the device it runs on."""
from __future__ import annotations

import dataclasses
import typing

import torch

from portbench.lib import spec


def build(cls, values: dict, where: str):
    """The dataclass ``cls`` of ``values``: a field whose type is (or is
    an ``Optional`` of) a dataclass is built from its nested object the
    same way.  A key ``cls`` lacks raises."""
    hints = typing.get_type_hints(cls)
    unknown = sorted(set(values) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise KeyError(f"{where}: {cls.__name__} has no field {unknown}")
    kw = {}
    for k, v in values.items():
        sub = [t for t in (hints[k], *typing.get_args(hints[k]))
               if dataclasses.is_dataclass(t)]
        kw[k] = build(sub[0], v, f"{where}.{k}") \
            if sub and isinstance(v, dict) else v
    return cls(**kw)


def model_config(name: str, m: dict):
    """The port's ``ModelConfig`` of the sizes ``m``, every key passed;
    its parameter layout, by shape and type, must be the one the harness
    draws."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import api
    cfg = build(ModelConfig, {"arch_id": name, **m}, f"{name}.model")
    got = {k: (tuple(t.shape), t.dtype)
           for k, t in spec.leaves(api.abstract_params(cfg))}
    want = {".".join(l.path): (l.shape, l.dtype) for l in spec.layout(m)}
    if got != want:
        raise RuntimeError(
            f"the port's parameter layout differs from the harness's: "
            f"{sorted(set(got.items()) ^ set(want.items()), key=str)}")
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
