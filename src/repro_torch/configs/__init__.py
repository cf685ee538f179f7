"""Architecture registry of the port.

``base`` and the per-architecture modules are copies of ``repro.configs``'s;
``input_specs`` (abstract JAX inputs for the dry-run) has no counterpart
here. Only the architectures whose layers the port runs are registered;
asking for another raises a ``KeyError`` that names the ported ones.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeSpec, SHAPES, SUBQUADRATIC, shape_grid
from . import qwen2_0_5b

_MODULES = {
    "qwen2-0.5b": qwen2_0_5b,
}
# the reference's other architectures, not ported yet (ROADMAP queue 1)
UNPORTED = ("deepseek-coder-33b", "gemma3-12b", "command-r-35b",
            "arctic-480b", "deepseek-v2-lite-16b", "recurrentgemma-2b",
            "musicgen-medium", "qwen2-vl-2b", "mamba2-1.3b")

ARCHS = tuple(_MODULES.keys())


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        what = "is not ported yet" if name in UNPORTED else "is unknown"
        raise KeyError(f"arch {name!r} {what}; ported: {sorted(_MODULES)}")
    return _MODULES[name].SMOKE if smoke else _MODULES[name].CONFIG


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "SUBQUADRATIC",
           "shape_grid", "ARCHS", "UNPORTED", "get_config"]
