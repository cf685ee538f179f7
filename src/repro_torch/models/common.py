"""Parameter-spec system: one tree of ``ParamSpec`` drives initialization
and parameter counts (the reference's ``repro.models.common``).

A spec tree is nested dicts (and, for the layers of a group, lists) with
``ParamSpec`` leaves; :func:`init_params` returns the same tree with tensors.
The logical axis names ("embed", "heads", "kv", "mlp", "vocab", ...) are
resolved to mesh axes by :mod:`repro_torch.distributed.sharding`, which
also places a tree of them on a device mesh as DTensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from ..device import resolve
from ..tree import leaves as tree_leaves    # noqa: F401 (re-exported)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "dense"      # dense | embed | zeros | ones | value
    value: float = 0.0       # for init == "value"
    fan_in_axes: Tuple[int, ...] = (0,)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec(shape, axes, init="dense", value=0.0, fan_in_axes=(0,)) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, value,
                     tuple(fan_in_axes))


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(f: Callable[[ParamSpec], Any], specs):
    """Apply ``f`` to every leaf in order (dict order, then list order)."""
    if isinstance(specs, dict):
        return {k: tree_map_specs(f, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [tree_map_specs(f, v) for v in specs]
    return f(specs)


def _init_one(s: ParamSpec, gen: torch.Generator, dtype, dev
              ) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=dev)
    if s.init == "value":
        return torch.full(s.shape, s.value, dtype=dtype, device=dev)
    fan_in = max(math.prod(s.shape[a] for a in s.fan_in_axes), 1)
    scale = 1.0 if s.init == "embed" else 1.0 / math.sqrt(fan_in)
    return (torch.randn(s.shape, generator=gen, dtype=torch.float32,
                        device=dev) * scale).to(dtype)


def init_params(specs, seed: int | torch.Generator = 0,
                dtype=torch.float32, device=None):
    """Materialize a spec tree on ``device`` (default CUDA): normal times
    1/sqrt(fan_in), scale 1 for ``embed``, zeros and ones as named. The
    random stream is a ``torch.Generator`` on that device (pass one, or a
    seed); it does not reproduce the reference's ``jax.random`` numbers, so
    parity tests carry the reference's weights over instead
    (:mod:`repro_torch.models.convert`)."""
    dev = resolve(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    return tree_map_specs(lambda s: _init_one(s, gen, dtype, dev), specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
