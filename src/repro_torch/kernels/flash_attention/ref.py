"""Plain PyTorch versions of the flash attention kernels (GQA-aware):
``attention_ref``, the function both kernels compute, and
``attention_bf16p_model``, a model of the wgmma kernel's arithmetic that
the tests and ``chip_smoke.py`` use to size its error (``bf16_errors``)."""
from __future__ import annotations

import math

import torch

from .kernel_sm90 import BLOCK_K

NEG_INF = -2.0e38
LOG2E = math.log2(math.e)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0. Returns
    (B, Sq, H, D) in f32. The causal mask is aligned bottom-right: query
    row i sees keys j <= i + Sk - Sq."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qf = q.to(torch.float32).reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return o.reshape(B, Sq, H, D)


def attention_bf16p_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None,
                          block_k: int | None = None, round_p: bool = True,
                          split_p: bool = False) -> torch.Tensor:
    """The wgmma kernel's arithmetic (``csrc/flash_attention_sm90.cu``) in
    plain PyTorch: an online softmax over ``block_k``-key tiles counted from
    key 0 (by default the kernel's tile at this head dim,
    ``kernel_sm90.BLOCK_K``; 128 where it has no instance), scores scaled
    into the log2 domain (``scale * log2(e)``) and exponentiated with
    ``exp2``, the running max starting at the fill -2e38,
    the row sum taken over the f32 weights, and the weights rounded to bf16
    before ``P V`` (``round_p``), all sums in f32. ``split_p`` rounds P to
    two bf16 parts instead, hi = bf16(p) and lo = bf16(p - hi), each
    multiplied by V, as the kernel's default schedules do. Same arguments
    and result as :func:`attention_ref`. With ``round_p=False`` it differs
    from ``attention_ref`` only by f32 rounding. Used by tests and the
    smoke to size the kernel's error, never on the model's path."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    block_k = block_k or BLOCK_K.get(D, 128)
    c = (scale if scale is not None else D ** -0.5) * LOG2E
    qf = q.to(torch.float32).reshape(B, Sq, K, G, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    last = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    m = torch.full((B, K, G, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        x = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, k0:k1]) * c
        if causal:
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            x = torch.where(cols <= last, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if round_p:
            hi = p.to(torch.bfloat16).to(torch.float32)
            parts = [hi, (p - hi).to(torch.bfloat16).to(torch.float32)] \
                if split_p else [hi]
        else:
            parts = [p]
        acc = acc * alpha
        for part in parts:
            acc = acc + torch.einsum("bkgqs,bskd->bkgqd", part, vf[:, k0:k1])
        m = m_new
    return (acc / l).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


# The bar of the wgmma kernel's output: its max abs and RMS error against the
# f32 oracle may exceed those of the model with one bf16 rounding of P
# (attention_bf16p_model on the same inputs) by BF16_MARGIN plus BF16_SLACK,
# and the max stays within the reference's bf16 bar BF16_CAP
# (tests/test_kernels.py). Two draws of the same bf16 rounding of P land
# close together; a wrong mask, tile, head or swizzle moves outputs by
# O(|v| / row length), far above 2^-9-sized noise. The kernel's default
# splits P into two bf16 parts, so it is also held to split_p_bound, which
# sees faults down to ~2^-18 |v|.
BF16_MARGIN = 1.25
BF16_SLACK = 1e-6
BF16_CAP = 2e-2


def bf16_errors(got: torch.Tensor, want: torch.Tensor,
                model: torch.Tensor, v: torch.Tensor | None = None) -> dict:
    """Errors of ``got`` (a kernel's output) and ``model`` against the f32
    oracle ``want``, and ``ok``: whether ``got`` meets the bar above and,
    given the values ``v``, the bound of a kernel that splits P
    (:func:`split_p_bound`)."""
    dk, dm = got.float() - want, model.float() - want
    e = {"max_abs": float(dk.abs().max()),
         "rms": float(dk.square().mean().sqrt()),
         "model_max_abs": float(dm.abs().max()),
         "model_rms": float(dm.square().mean().sqrt())}
    e["ok"] = (e["max_abs"] <= BF16_CAP
               and e["max_abs"] <= BF16_MARGIN * e["model_max_abs"]
               + BF16_SLACK
               and e["rms"] <= BF16_MARGIN * e["model_rms"] + BF16_SLACK)
    if v is not None:
        e["split_p_bound"] = split_p_bound(v)
        e["ok"] = e["ok"] and e["max_abs"] <= e["split_p_bound"]
    return e


# f32 rounding and order of sums, the reference's f32 bar
# (tests/test_kernels.py:74)
F32_TOL = 2e-6


def split_p_bound(v: torch.Tensor) -> float:
    """Largest error against the f32 oracle of attention whose weights are
    split into two bf16 parts: hi = bf16(p) is within 2^-9 p, lo =
    bf16(p - hi) within 2^-9 |p - hi|, so |p - hi - lo| <= 2^-18 p and an
    output, a p-weighted mean of values, moves by at most 2^-18 max |v|;
    plus the f32 bar for rounding and the order of sums."""
    return 2.0 ** -18 * float(v.float().abs().max()) + F32_TOL
