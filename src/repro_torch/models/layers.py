"""Shared layers: RMSNorm, SiLU-gated MLP, rotary embeddings, embedding.

The reference's ``repro.models.layers`` minus ``apply_mrope`` (qwen2-vl's
M-RoPE, not ported yet). Functions take a parameter dict and tensors;
weights are cast to the activation's dtype at use, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import spec


# -------------------------------------------------------------- RMSNorm

def rmsnorm_spec(d: int):
    return {"scale": spec((d,), (None,), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalized in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(dt)


# -------------------------------------------------------------- MLP (GLU)

def mlp_spec(d: int, ff: int):
    return {
        "wi_gate": spec((d, ff), ("embed", "mlp")),
        "wi_up": spec((d, ff), ("embed", "mlp")),
        "wo": spec((ff, d), ("mlp", "embed")),
    }


def mlp(p, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    gate = act(x @ p["wi_gate"].to(x.dtype))
    up = x @ p["wi_up"].to(x.dtype)
    return (gate * up) @ p["wo"].to(x.dtype)


# -------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotates the
    two halves of D against each other (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs         # (.., S, D/2)
    ang = ang[..., None, :]                                      # (.., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- embedding

def embed_spec(vocab: int, d: int):
    return {"table": spec((vocab, d), ("vocab", "embed"), init="embed")}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed_spec(d: int, vocab: int):
    """One output head (the reference's multi-codebook heads are musicgen's,
    not ported)."""
    return {"w": spec((d, vocab), ("embed", "vocab"))}


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype)
