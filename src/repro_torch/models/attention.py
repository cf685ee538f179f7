"""GQA attention (global layers), the reference's ``repro.models.attention``
as far as qwen2 serving needs it.

Modes:
  * ``train`` / ``prefill``: full-sequence causal attention. Prefill also
    returns the KV cache, padded to ``max_len`` slots.
  * ``decode``: one query token against the cache; the new position is
    written at slot ``pos % S_cache`` and keys ``kpos <= pos`` are attended.

With ``use_kernel`` the full-sequence attention goes through the hand-written CUDA flash kernel
(:mod:`repro_torch.kernels.flash_attention`); otherwise through the plain
einsum/softmax path ``_sdpa``. Not ported yet, and raising
``NotImplementedError``: sliding-window ``local`` layers (ring-buffer
cache), MLA, M-RoPE and the query-chunked ``_sdpa_chunked``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.flash_attention import flash_attention
from .common import spec
from .layers import apply_rope

NEG_INF = -2.0e38


def gqa_spec(cfg):
    d, hd = cfg.d_model, cfg.hd
    s = {
        "wq": spec((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": spec((d, cfg.n_kv_heads * hd), ("embed", "kv")),
        "wv": spec((d, cfg.n_kv_heads * hd), ("embed", "kv")),
        "wo": spec((cfg.n_heads * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = spec((cfg.n_heads * hd,), ("heads",), init="zeros")
        s["bk"] = spec((cfg.n_kv_heads * hd,), ("kv",), init="zeros")
        s["bv"] = spec((cfg.n_kv_heads * hd,), ("kv",), init="zeros")
    return s


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, S_cache, K, D)
    v: torch.Tensor        # (B, S_cache, K, D)


def gqa_cache_len(cfg, kind: str, seq_len: int) -> int:
    """Cache slots of a ``global`` layer: one per position. (The reference
    caps ``local`` layers at ``cfg.window``; they are not ported.)"""
    if kind != "global":
        raise NotImplementedError(f"gqa_cache_len: {kind!r} layers are not "
                                  "ported yet")
    return seq_len


def _qkv(p, x, cfg):
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """Grouped scaled-dot-product attention in f32. q: (B,Sq,H,Dk);
    k: (B,Sk,K,Dk); v: (B,Sk,K,Dv). mask: broadcastable to (B, 1, Sq, Sk)
    (True = attend). Returns (B, Sq, H*Dv) f32."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    Dv = v.shape[3]
    G = H // K
    q = q.reshape(B, Sq, K, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return out.reshape(B, Sq, H * Dv)


def _causal_mask(Sq, Sk, device=None):
    """(Sq, Sk) mask, True = attend."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    return kpos <= qpos


def _pad_seq(arr, target: int, axis: int = 1):
    if arr.shape[axis] >= target:
        return arr
    pad = list(arr.shape)
    pad[axis] = target - arr.shape[axis]
    return torch.cat([arr, arr.new_zeros(pad)], dim=axis)


def gqa_attend(p, x, cfg, kind: str, mode: str, positions=None,
               cache: Optional[KVCache] = None, pos=None, positions3=None,
               use_kernel: bool = False, max_len: Optional[int] = None):
    """Returns (out, new_cache|None). ``max_len``: prefill cache capacity
    (a serving runtime preallocates room for the tokens to be decoded).
    ``pos``: the decode position, an int or a 0-d integer tensor."""
    if kind != "global":
        raise NotImplementedError(
            f"gqa_attend: {kind!r} layers (sliding window, ring-buffer "
            "cache) are not ported yet")
    if cfg.mrope and positions3 is not None:
        raise NotImplementedError("gqa_attend: M-RoPE is not ported yet")
    B, S, _ = x.shape
    hd = cfg.hd
    scale = hd ** -0.5

    if mode in ("train", "prefill"):
        q, k, v = _qkv(p, x, cfg)
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        # the reference's switch is `use_kernel and window is None`; only
        # global (unwindowed) layers get this far
        if use_kernel:
            out = flash_attention(q, k, v, causal=True, scale=scale)
            out = out.reshape(B, S, cfg.n_heads * hd)
        elif cfg.attn_chunk and S > cfg.attn_chunk:
            raise NotImplementedError(
                "gqa_attend: the query-chunked path (attn_chunk) is not "
                "ported yet")
        else:
            mask = _causal_mask(S, S, device=x.device)[None, None]
            out = _sdpa(q, k, v, mask, scale)
        out = out.to(x.dtype) @ p["wo"].to(x.dtype)
        new_cache = None
        if mode == "prefill":
            cap = gqa_cache_len(cfg, kind, max_len or S)
            cl = min(gqa_cache_len(cfg, kind, S), cap)
            kt, vt = k[:, S - cl:], v[:, S - cl:]
            new_cache = KVCache(k=_pad_seq(kt, cap), v=_pad_seq(vt, cap))
        return out, new_cache

    # ----------------------------------------------------------- decode
    assert cache is not None and pos is not None
    q, k, v = _qkv(p, x, cfg)                    # S == 1
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    posb = pos.expand(B)[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    Sc = cache.k.shape[1]
    slot = (pos % Sc).reshape(1)
    # write the single new position at `slot` (into copies: the caller's
    # cache stays as it was, as with the reference's immutable arrays)
    nk = cache.k.index_copy(1, slot, k.to(cache.k.dtype))
    nv = cache.v.index_copy(1, slot, v.to(cache.v.dtype))
    kpos = torch.arange(Sc, dtype=torch.int64, device=x.device)
    valid = kpos <= pos
    mask = valid[None, None, None, :]
    out = _sdpa(q, nk, nv, mask[:, 0], scale)
    out = out.to(x.dtype) @ p["wo"].to(x.dtype)
    return out, KVCache(k=nk, v=nv)
