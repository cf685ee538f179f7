"""Plain PyTorch version of the flash attention kernel (GQA-aware)."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


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
