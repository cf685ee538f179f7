"""Shared layers: RMSNorm, SiLU-gated MLP, rotary embeddings (and qwen2-vl's
M-RoPE), embedding and the output head (musicgen's codebook heads too).

The reference's ``repro.models.layers``. Functions take a parameter dict and
tensors; weights are cast to the activation's dtype at use, as in the
reference.
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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 1e4, sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: rotary over 3 position streams (t, h, w).

    x: (B, S, H, D); positions3: (3, B, S). ``sections`` are per-stream
    frequency-pair counts summing to D/2 at D = 128; they are scaled to D/2
    in integers (``sections * (D/2) // sum``), and a slot past the last
    section (rounding) takes position 0, as in the reference.
    """
    d = x.shape[-1]
    half = d // 2
    dev = x.device
    freqs = rope_freqs(d, theta, dev)                            # (half,)
    # partition the half-dim frequency slots into the 3 sections
    sec = torch.tensor(sections, dtype=torch.int32, device=dev)
    sec = (sec * half) // sec.sum()
    bounds = torch.cumsum(sec, 0)
    lo = torch.cat([bounds.new_zeros(1), bounds[:-1]])
    slot = torch.arange(half, device=dev)
    which = (slot[None, :] >= lo[:, None]) & \
        (slot[None, :] < bounds[:, None])                        # (3, half)
    # per-slot position: pick the stream owning this slot
    pos = torch.einsum("kbs,kf->bsf", positions3.to(torch.float32),
                       which.to(torch.float32))                  # (B, S, half)
    ang = pos[..., None, :] * freqs                              # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- embedding

def embed_spec(vocab: int, d: int):
    return {"table": spec((vocab, d), ("vocab", "embed"), init="embed")}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: DTensor has a rule for its backward
    return F.embedding(tokens, p["table"])


def unembed_spec(d: int, vocab: int, n_heads: int = 1):
    """One output head, or ``n_heads`` > 1 parallel heads (musicgen's
    codebooks) as one (K, d, V) weight."""
    if n_heads > 1:
        return {"w": spec((n_heads, d, vocab), (None, "embed", "vocab"),
                          fan_in_axes=(1,))}
    return {"w": spec((d, vocab), ("embed", "vocab"))}


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., V), or (..., K, V) with codebook heads: one
    product a head (on a mesh, torch 2.11's DTensor cannot flatten a
    single einsum's sharded operands)."""
    w = p["w"]
    if w.dim() == 3:
        return torch.stack([x @ w[i].to(x.dtype) for i in range(w.shape[0])],
                           dim=-2)
    return x @ w.to(x.dtype)
