"""Architecture registry of the port.

``base`` and the per-architecture modules are copies of ``repro.configs``'s;
``input_specs`` (abstract JAX inputs for the dry-run) has no counterpart
here.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeSpec, SHAPES, SUBQUADRATIC, shape_grid
from . import (deepseek_coder_33b, qwen2_0_5b, gemma3_12b, command_r_35b,
               arctic_480b, deepseek_v2_lite_16b, recurrentgemma_2b,
               musicgen_medium, qwen2_vl_2b, mamba2_1_3b)

_MODULES = {
    "deepseek-coder-33b": deepseek_coder_33b,
    "qwen2-0.5b": qwen2_0_5b,
    "gemma3-12b": gemma3_12b,
    "command-r-35b": command_r_35b,
    "arctic-480b": arctic_480b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "musicgen-medium": musicgen_medium,
    "qwen2-vl-2b": qwen2_vl_2b,
    "mamba2-1.3b": mamba2_1_3b,
}

ARCHS = tuple(_MODULES.keys())


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return _MODULES[name].SMOKE if smoke else _MODULES[name].CONFIG


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "SUBQUADRATIC",
           "shape_grid", "ARCHS", "get_config"]
