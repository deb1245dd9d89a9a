"""Architecture registry of the port (``repro/configs/__init__.py``).

Each architecture lives in its own module exposing ``ARCH_ID``, ``MODEL``
(a :class:`~repro_torch.configs.base.ModelConfig`) and ``OPTIMIZER``,
copied from the reference's module; the ten are the reference's, in its
order.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    RunConfig,
    SecureStreamConfig,
    ShapeConfig,
    ShardingConfig,
    SHAPES,
    SSMConfig,
    XLSTMConfig,
    reduce_for_smoke,
)

_ARCH_MODULES: Dict[str, str] = {
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "qwen2.5-32b": "repro_torch.configs.qwen2p5_32b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "llama3.2-1b": "repro_torch.configs.llama3p2_1b",
    "qwen2.5-14b": "repro_torch.configs.qwen2p5_14b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
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


def all_cells() -> List[Tuple[str, str]]:
    """The full assignment grid: 10 archs x 4 shapes = 40 cells."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]


def cell_supported(arch_id: str, shape: str) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; reason if not.

    Per the assignment: long_500k needs sub-quadratic attention — skipped
    (and recorded) for pure full-attention archs.
    """
    m = get_model_config(arch_id)
    if shape == "long_500k" and not m.sub_quadratic:
        return False, ("full-attention arch: 500k-token decode is the "
                       "quadratic regime this shape excludes (DESIGN.md §4)")
    return True, ""
