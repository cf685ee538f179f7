"""AdamW with global-norm clipping and a cosine schedule (the reference's
``repro.optim.adamw``).

Parameters and gradients are trees of tensors (nested dicts and lists; see
:mod:`repro_torch.tree`). The update runs in f32 and writes each parameter
back at its own dtype. Moments are stored at ``state_bits`` 32 (f32), 16
(bf16) or 8 (int8 with one f32 scale per last-axis row, shaped as the
parameter). Every scalar the reference computes in f32 (the schedule, the
bias corrections ``b ** step``) is an f32 tensor here too, and rounding is
half to even in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import tree

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # moment storage: 32 (f32), 16 (bf16), 8 (blockwise int8)
    state_bits: int = 32


def _q8(x: torch.Tensor):
    """Shape-preserving int8 quantization: q mirrors the parameter's shape;
    one f32 scale per last-axis row."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-20
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(F32)}


def _dq8(packed) -> torch.Tensor:
    return packed["q"].to(F32) * packed["s"]


def _pack(x: torch.Tensor, bits: int):
    if bits == 32:
        return x
    if bits == 16:
        return x.to(torch.bfloat16)
    return _q8(x)


def _unpack(x, bits: int) -> torch.Tensor:
    if bits == 32:
        return x
    if bits == 16:
        return x.to(F32)
    return _dq8(x)


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr`` at
    ``decay_steps``; f32."""
    step = torch.as_tensor(step).to(F32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) \
        * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, state_bits: int = 32) -> AdamWState:
    """Zero moments at ``state_bits`` on the parameters' devices (a
    DTensor parameter's moments are DTensors of its placement); step 0."""
    def z(p):
        return _pack(torch.zeros_like(p, dtype=F32,
                                      memory_format=torch.contiguous_format),
                     state_bits)
    dev = tree.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree.map_up_to(z, params),
                      v=tree.map_up_to(z, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32, the leaves summed
    in the reference's tree order."""
    return torch.sqrt(sum(x.to(F32).square().sum()
                          for x in tree.leaves(grads)))


@torch.no_grad()
def apply(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=F32, device=stepf.device) ** stepf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=F32, device=stepf.device) ** stepf

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m = cfg.b1 * _unpack(m, cfg.state_bits) + (1 - cfg.b1) * g
        v = cfg.b2 * _unpack(v, cfg.state_bits) + (1 - cfg.b2) * g.square()
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.to(F32)
        newp = (p.to(F32) - lr * delta).to(p.dtype)
        return newp, _pack(m, cfg.state_bits), _pack(v, cfg.state_bits)

    out = tree.map_up_to(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree.map_up_to(lambda o: o[i], out)
                           for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v), \
        {"grad_norm": gnorm, "lr": lr}
