"""Architecture registry of the port (``repro/configs/__init__.py``).

Each ported architecture lives in its own module exposing ``ARCH_ID``,
``MODEL`` (a :class:`~repro_torch.configs.base.ModelConfig`) and
``OPTIMIZER``, copied from the reference's module.
Only ``llama3.2-1b`` (the dense family) is ported; the other nine
architectures of the reference raise ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    SecureStreamConfig,
    ShapeConfig,
    ShardingConfig,
    SHAPES,
    reduce_for_smoke,
)

_ARCH_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3p2_1b",
}
#: the reference's other architectures, whose families (moe, ssm, hybrid,
#: vlm, audio) or configs are not ported yet
NOT_PORTED = ("kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "xlstm-125m",
              "internvl2-76b", "zamba2-1.2b", "qwen2.5-32b", "granite-34b",
              "qwen2.5-14b", "musicgen-large")

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet "
                       f"(ROADMAP Queue 1 item 7); ported: {ARCH_IDS}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_model_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).MODEL


def get_optimizer_config(arch_id: str) -> OptimizerConfig:
    return _module(arch_id).OPTIMIZER


def get_run_config(arch_id: str, shape: str, **overrides) -> RunConfig:
    mod = _module(arch_id)
    kw = dict(model=mod.MODEL, shape=SHAPES[shape],
              optimizer=mod.OPTIMIZER)
    kw.update(overrides)
    return RunConfig(**kw)
