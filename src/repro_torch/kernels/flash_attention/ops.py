"""(B, S, H, D)-layout entry point of the flash attention kernel.

``flash_attention`` launches the CUDA kernel for CUDA tensors (the kernel
reads and writes this layout through strides, so nothing is transposed) and
counts launches in ``flash_attention.launches``. For CPU tensors it runs the
plain version (:func:`attention_ref`). Anything else raises before a launch:
a build or launch failure is an error, never a fallback.
"""
from __future__ import annotations

import torch

from ...device import resolve
from . import kernel
from .ref import attention_ref


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel's vector loads can read it, else an
    aligned contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D). Returns (B, Sq, H, D) f32.
    Causal masking is aligned bottom-right (row i sees keys
    j <= i + Sk - Sq), as the reference's ``attention_ref``."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal, scale)
    resolve(None)               # the kernel runs on the card: raise without
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention: q, k and v must lie on one CUDA "
                         f"device, got {q.device}, {k.device} and {v.device}")
    if q.dtype not in kernel.DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share a dtype in "
                        f"{kernel.DTYPES}, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: need q (B, Sq, H, D) and k/v "
                         f"(B, Sk, K, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if D not in kernel.HEAD_DIMS or K == 0 or H % K or Sk == 0 \
            or max(B, H) > 65535 or max(Sq, Sk) >= 2**31:
        raise ValueError(f"flash_attention: unsupported sizes B={B} Sq={Sq} "
                         f"Sk={Sk} H={H} K={K} D={D} (D in "
                         f"{kernel.HEAD_DIMS}, H % K == 0, Sk > 0)")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, Sq, H, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    kernel.launch(_aligned(q), _aligned(k), _aligned(v), out, causal, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
