"""Architecture registry: one module per config, ``get(name)`` API.

The port serves the dense ``"ad"`` stack only so far; the registry holds
the configurations it can run."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get(n) for n in ARCH_NAMES}
