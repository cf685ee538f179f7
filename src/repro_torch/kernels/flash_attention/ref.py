"""Plain PyTorch versions of the flash attention kernels (GQA-aware):
``attention_ref``, the function every kernel computes;
``attention_bf16p_model``, a model of the bf16 wgmma kernel's arithmetic
that the tests and ``chip_smoke.py`` use to size its error
(``bf16_errors``); and ``attention_3xtf32_model`` with ``tf32x3_layout``,
the f32 tensor-core kernel's arithmetic and its prep kernel's layout."""
from __future__ import annotations

import math

import torch

from .kernel_sm90 import BLOCK_K
from .kernel_tf32 import BLOCK_K as TF32_BLOCK_K, padded

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


# Storage position p of each group of 8 keys in the tf32x3 kernel's V^T
# holds key KEY_ORDER[p]: the wgmma A fragment of a k-step holds columns t
# and t + 4 of P where the S accumulator holds 2t and 2t + 1
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
_TF32_LOW = 0x1FFF              # the 13 low mantissa bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: half a TF32 ulp added to the
    magnitude's bits, then the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~_TF32_LOW).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as a TF32 tensor-core operand reads it: the low 13
    mantissa bits dropped."""
    return (x.float().contiguous().view(torch.int32)
            & ~_TF32_LOW).view(torch.float32)


def tf32x3_layout(k: torch.Tensor, v: torch.Tensor,
                  block_k: int | None = None) -> tuple[torch.Tensor, ...]:
    """The tf32x3 kernel's prep output in plain PyTorch, for k and v
    (B, Sk, K, D): K_hi, K_lo (B*K, Skp, DP) and V^T_hi, V^T_lo
    (B*K, D, Skp), hi = :func:`tf32_rna`, lo = x - hi (exact), Skp and DP
    as ``kernel_tf32.padded`` gives them (Sk padded to the key tile and to
    the prep's 32 keys, D rounded up to 32), zero past Sk and D, V^T's keys
    in :data:`KEY_ORDER` within each group of 8."""
    B, Sk, K, D = k.shape
    skp, dp = padded(D, Sk, block_k)
    kp = torch.zeros((B, K, skp, dp), device=k.device)
    kp[:, :, :Sk, :D] = k.float().permute(0, 2, 1, 3)
    vp = torch.zeros((B, K, skp, D), device=v.device)
    vp[:, :, :Sk] = v.float().permute(0, 2, 1, 3)
    pos = torch.arange(skp, device=v.device)
    order = pos - pos % 8 + torch.tensor(KEY_ORDER, device=v.device)[pos % 8]
    kp = kp.reshape(B * K, skp, -1)
    vt = vp[:, :, order].transpose(-1, -2).reshape(B * K, D, skp)
    k_hi, vt_hi = tf32_rna(kp), tf32_rna(vt)
    return k_hi, kp - k_hi, vt_hi, vt - vt_hi


def _split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = TF32(x) rounded to nearest, lo = x - hi as the tensor core reads
    it (truncated)."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def attention_3xtf32_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True, scale: float | None = None,
                           block_k: int | None = None) -> torch.Tensor:
    """The tf32x3 kernel's arithmetic (``csrc/flash_attention_tf32.cu``) in
    plain PyTorch: an online softmax over ``block_k``-key tiles counted from
    key 0 (by default the kernel's tile at this head dim,
    ``kernel_tf32.BLOCK_K``; 64 where it has no instance); every product
    a.b taken as a_hi b_lo + a_lo b_hi + a_hi b_hi (small terms first) with
    hi = TF32 rounded to nearest and lo = a - hi truncated to TF32, for
    Q K^T and for P V; scores scaled into the log2 domain (``scale *
    log2(e)``) and exponentiated with ``exp2``, the running max starting at
    the fill -2e38, the row sum over the f32 weights, all sums in f32. Same
    arguments and result as :func:`attention_ref`. Used by tests and the
    smoke to size the kernel's error, never on the model's path."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    block_k = block_k or TF32_BLOCK_K.get(D, 64)
    c = (scale if scale is not None else D ** -0.5) * LOG2E
    q_hi, q_lo = _split3(q.to(torch.float32).reshape(B, Sq, K, G, D))
    k_hi, k_lo = _split3(k)
    v_hi, v_lo = _split3(v)
    last = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    m = torch.full((B, K, G, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, Sq, D), device=q.device)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)

        def qk(a, b):
            return torch.einsum("bqkgd,bskd->bkgqs", a, b[:, k0:k1])

        def pv(a, b):
            return torch.einsum("bkgqs,bskd->bkgqd", a, b[:, k0:k1])
        x = (qk(q_hi, k_lo) + qk(q_lo, k_hi) + qk(q_hi, k_hi)) * c
        if causal:
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            x = torch.where(cols <= last, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi, p_lo = _split3(p)
        acc = acc * alpha + pv(p_hi, v_lo) + pv(p_lo, v_hi) + pv(p_hi, v_hi)
        m = m_new
    return (acc / l).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
