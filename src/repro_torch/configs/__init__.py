"""Architecture registry: one module per config, ``get(name)`` API.

The registry holds the reference's configurations, in its order: the
dense ``"ad"`` stack, sliding windows included, the MoE blocks ``"ae"``
(granite-moe) and ``"ar"`` (arctic, with its dense residual), the
encoder-decoder seamless-m4t-medium and the vision llama-3.2-vision-11b
(``"adx"`` cross-attention, ``"enc"`` encoder blocks), the
Mamba/attention/MoE hybrid jamba and the xLSTM stack; then the port's
own: granite-4.0-h-small (Mamba-2 and attention blocks with a shared
expert, ``"ms"`` and ``"as"``), which the reference has no model for."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "granite-20b": "granite_20b",
    "gemma-7b": "gemma_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "arctic-480b": "arctic_480b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-1.3b": "xlstm_1_3b",
    # the port's own, beyond the reference's registry
    "granite-4.0-h-small": "granite_4_0_h_small",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get(n) for n in ARCH_NAMES}
