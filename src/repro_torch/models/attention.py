"""Attention mixers: GQA (global and sliding-window ``local`` layers) and MLA
(DeepSeek-V2), the reference's ``repro.models.attention``.

Modes:
  * ``train`` / ``prefill``: full-sequence causal attention (optionally
    sliding-window). Prefill also returns the cache, padded to ``max_len``
    slots.
  * ``decode``: one query token against a cache. Sliding-window layers keep
    a **ring buffer** of ``window`` slots (absolute position p lives at slot
    p % window); global layers keep the full context. MLA decodes through
    the **absorbed** form in f32: scores and values in the latent space, the
    per-head K/V up-projections folded into the query and output
    projections, so the latent cache is never expanded.

With ``use_kernel`` a global layer's full-sequence attention goes through the
hand-written CUDA flash kernel (:mod:`repro_torch.kernels.flash_attention`;
on each rank's local heads under a mesh, :func:`heads_local`, as the plain
attention is);
local layers, MLA and every other path take the plain einsum/softmax path
``_sdpa`` (query-chunked by ``_sdpa_chunked`` when ``cfg.attn_chunk`` is set
and shorter than the sequence), as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import is_dtensor
from ..distributed.sharding import shard_local
from ..kernels.flash_attention import flash_attention
from .common import spec
from .layers import apply_rope, apply_mrope

NEG_INF = -2.0e38


# ===========================================================================
# GQA
# ===========================================================================

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
    """Cache slots: one per position, at most ``cfg.window`` for ``local``."""
    return min(seq_len, cfg.window) if kind == "local" else seq_len


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
    k: (B,Sk,K,Dk); v: (B,Sk,K,Dv) (Dv may differ: MLA). mask: broadcastable
    to (B, 1, Sq, Sk) (True = attend). Returns (B, Sq, H*Dv) f32."""
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


def _causal_mask(Sq, Sk, window: Optional[int] = None, offset: int = 0,
                 device=None):
    """(Sq, Sk) mask, True = attend; ``offset`` = the number of key
    positions before the query block; ``window`` keeps the last ``window``
    keys of each query (itself included)."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _sdpa_chunked(q, k, v, scale, window: Optional[int], chunk: int):
    """Query-block-chunked causal attention: the (Sq, Sk) score matrix
    exists one (chunk, Sk) slab at a time, a loop over the query blocks.
    When autograd records, each block runs under a non-reentrant checkpoint,
    so the backward pass recomputes its slab instead of keeping it (the
    reference's ``jax.checkpoint`` block body)."""
    B, Sq, H, D = q.shape
    assert Sq % chunk == 0, (Sq, chunk)
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    def block(qb, k, v, offset):
        mask = _causal_mask(chunk, k.shape[1], window, offset=offset,
                            device=qb.device)[None, None]
        return _sdpa(qb, k, v, mask, scale)                # (B, c, H*Dv)

    outs = []
    for qi in range(Sq // chunk):
        qb = q[:, qi * chunk:(qi + 1) * chunk]
        if recompute:
            outs.append(checkpoint(block, qb, k, v, qi * chunk,
                                   use_reentrant=False))
        else:
            outs.append(block(qb, k, v, qi * chunk))
    return torch.cat(outs, dim=1)


def heads_local(fn, q, k, v, *args):
    """``fn(q, k, v, *args)``, an attention whose output (B, S, H, ...) or
    (B, S, H * Dv) keeps the batch first and the heads third. DTensors
    (a mesh) run it on each rank's local batch and heads
    (:func:`~repro_torch.distributed.sharding.shard_local`): q, k and v are
    placed with the batch over the data axes and the heads over "model"
    (when both H and K divide by it, else whole: never a forced split),
    each rank runs ``fn`` on its shards, and the output comes back as a
    DTensor of the same placement. Attention never mixes heads, and a
    contiguous split keeps query head h with kv head h // (H / K) on the
    same rank."""
    return shard_local(lambda q, k, v: fn(q, k, v, *args), (q, k, v),
                       ((0, 2),) * 3, (0, 2))


def _roll(t, shifts: int, dim: int):
    """``torch.roll(t, shifts, dim)``; a DTensor ``t`` is rolled shard by
    shard, whole along ``dim`` (torch 2.11's DTensor has no rule for
    ``roll``)."""
    if not is_dtensor(t):
        return torch.roll(t, shifts=shifts, dims=dim)
    from torch.distributed.tensor import DTensor
    from ..distributed.sharding import unshard_dim
    t = unshard_dim(t, dim)
    return DTensor.from_local(torch.roll(t.to_local(), shifts=shifts,
                                         dims=dim), t.device_mesh,
                              t.placements, run_check=False)


def _index_copy(t, dim: int, index, src):
    """``t.index_copy(dim, index, src)``: a copy of ``t`` with the slices
    ``index`` of ``dim`` taken from ``src``. A DTensor ``t`` (a cache on a
    mesh) is written shard by shard, whole along ``dim``; DTensor has no
    rule of its own for the op."""
    if not is_dtensor(t):
        return t.index_copy(dim, index, src)
    from torch.distributed.tensor import DTensor, distribute_tensor
    from ..distributed.sharding import unshard_dim
    t = unshard_dim(t, dim)
    mesh, pl = t.device_mesh, t.placements
    src = (src.redistribute(mesh, pl) if is_dtensor(src) else
           distribute_tensor(src, mesh, pl, src_data_rank=None))
    return DTensor.from_local(
        t.to_local().index_copy(dim, index, src.to_local()), mesh, pl)


def _pad_seq(arr, target: int, axis: int = 1):
    if arr.shape[axis] >= target:
        return arr
    pad = list(arr.shape)
    pad[axis] = target - arr.shape[axis]
    return torch.cat([arr, arr.new_zeros(pad)], dim=axis)


def _decode_pos(pos, x):
    """The decode position as a 0-d int64 tensor on ``x``'s device."""
    return torch.as_tensor(pos, dtype=torch.int64, device=x.device)


def gqa_attend(p, x, cfg, kind: str, mode: str, positions=None,
               cache: Optional[KVCache] = None, pos=None, positions3=None,
               use_kernel: bool = False, max_len: Optional[int] = None):
    """Returns (out, new_cache|None). ``max_len``: prefill cache capacity
    (a serving runtime preallocates room for the tokens to be decoded).
    ``pos``: the decode position, an int or a 0-d integer tensor.
    ``positions3`` (3, B, S): M-RoPE position streams, used when
    ``cfg.mrope``."""
    B, S, _ = x.shape
    hd = cfg.hd
    scale = hd ** -0.5
    window = cfg.window if kind == "local" else None
    mrope = cfg.mrope and positions3 is not None

    if mode in ("train", "prefill"):
        q, k, v = _qkv(p, x, cfg)
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None, :]
        if mrope:
            q = apply_mrope(q, positions3, cfg.rope_theta)
            k = apply_mrope(k, positions3, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if use_kernel and window is None:
            out = heads_local(lambda q, k, v: flash_attention(
                q, k, v, causal=True, scale=scale), q, k, v)
            out = out.reshape(B, S, cfg.n_heads * hd)
        elif cfg.attn_chunk and S > cfg.attn_chunk:
            out = heads_local(_sdpa_chunked, q, k, v, scale, window,
                              cfg.attn_chunk)
        else:
            mask = _causal_mask(S, S, window, device=x.device)[None, None]
            out = heads_local(_sdpa, q, k, v, mask, scale)
        out = out.to(x.dtype) @ p["wo"].to(x.dtype)
        new_cache = None
        if mode == "prefill":
            cap = gqa_cache_len(cfg, kind, max_len or S)
            cl = min(gqa_cache_len(cfg, kind, S), cap)
            kt, vt = k[:, S - cl:], v[:, S - cl:]
            if window is not None and cl == window:
                # ring order: absolute position p lives at slot p % window
                kt = _roll(kt, S % window, 1)
                vt = _roll(vt, S % window, 1)
            new_cache = KVCache(k=_pad_seq(kt, cap), v=_pad_seq(vt, cap))
        return out, new_cache

    # ----------------------------------------------------------- decode
    assert cache is not None and pos is not None
    q, k, v = _qkv(p, x, cfg)                    # S == 1
    pos = _decode_pos(pos, x)
    posb = pos.expand(B)[:, None]
    if mrope:
        q = apply_mrope(q, positions3, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.rope_theta)
    else:
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    Sc = cache.k.shape[1]
    slot = (pos % Sc).reshape(1)
    # write the single new position at `slot` (into copies: the caller's
    # cache stays as it was, as with the reference's immutable arrays)
    nk = _index_copy(cache.k, 1, slot, k.to(cache.k.dtype))
    nv = _index_copy(cache.v, 1, slot, v.to(cache.v.dtype))
    kpos = torch.arange(Sc, dtype=torch.int64, device=x.device)
    if window is None:
        valid = kpos <= pos
    else:
        # ring buffer: slot i holds the absolute position with i = abs % Sc
        # (`%` on tensors is the floor modulo, as jnp's)
        abs_pos = pos - ((slot - kpos) % Sc)
        valid = (abs_pos >= 0) & (abs_pos >= pos - window + 1)
    mask = valid[None, None, None, :]
    out = heads_local(_sdpa, q, nk, nv, mask[:, 0], scale)
    out = out.to(x.dtype) @ p["wo"].to(x.dtype)
    return out, KVCache(k=nk, v=nv)


# ===========================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# ===========================================================================

def mla_spec(cfg):
    d = cfg.d_model
    H = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": spec((d, H * qk), ("embed", "heads")),
        "w_dkv": spec((d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                      ("embed", "state")),
        "kv_norm": spec((cfg.kv_lora_rank,), (None,), init="ones"),
        "w_uk": spec((cfg.kv_lora_rank, H * cfg.qk_nope_dim),
                     ("state", "heads")),
        "w_uv": spec((cfg.kv_lora_rank, H * cfg.v_head_dim),
                     ("state", "heads")),
        "wo": spec((H * cfg.v_head_dim, d), ("heads", "embed")),
    }


class MLACache(NamedTuple):
    ckv: torch.Tensor      # (B, S, kv_lora_rank)
    krope: torch.Tensor    # (B, S, qk_rope_dim)


def _mla_qkv_latent(p, x, cfg):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    dkv = x @ p["w_dkv"].to(x.dtype)
    ckv, krope = dkv[..., :cfg.kv_lora_rank], dkv[..., cfg.kv_lora_rank:]
    # RMS-normalize the latent (as in DeepSeek-V2)
    c32 = ckv.to(torch.float32)
    var = c32.square().mean(dim=-1, keepdim=True)
    ckv = (c32 * torch.rsqrt(var + 1e-6)
           * p["kv_norm"].to(torch.float32)).to(x.dtype)
    return q_nope, q_rope, ckv, krope


def mla_attend(p, x, cfg, mode: str, positions=None,
               cache: Optional[MLACache] = None, pos=None,
               max_len: Optional[int] = None):
    """Returns (out, new_cache|None); the cache holds the normalised latent
    and the rotated shared rope key, one row per position."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    R = cfg.kv_lora_rank
    scale = (dn + dr) ** -0.5
    f32 = torch.float32
    q_nope, q_rope, ckv, krope = _mla_qkv_latent(p, x, cfg)

    if mode in ("train", "prefill"):
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None, :]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        krope_r = apply_rope(krope[:, :, None, :], positions,
                             cfg.rope_theta)[:, :, 0]
        k_nope = (ckv @ p["w_uk"].to(x.dtype)).reshape(B, S, H, dn)
        v = (ckv @ p["w_uv"].to(x.dtype)).reshape(B, S, H, dv)
        # concat trick: [q_nope; q_rope] . [k_nope; k_rope] — one GQA-style
        # attention (K == H), so the chunked path is shared
        q_cat = torch.cat([q_nope, q_rope], dim=-1)
        k_cat = torch.cat(
            [k_nope, krope_r[:, :, None, :].expand(B, S, H, dr)
             .to(k_nope.dtype)], dim=-1)
        if cfg.attn_chunk and S > cfg.attn_chunk:
            out = heads_local(_sdpa_chunked, q_cat, k_cat, v, scale, None,
                              cfg.attn_chunk)
        else:
            mask = _causal_mask(S, S, device=x.device)[None, None]
            out = heads_local(_sdpa, q_cat, k_cat, v, mask, scale)
        out = out.to(x.dtype) @ p["wo"].to(x.dtype)
        new_cache = None
        if mode == "prefill":
            cap = max_len or S
            new_cache = MLACache(ckv=_pad_seq(ckv, cap),
                                 krope=_pad_seq(krope_r, cap))
        return out, new_cache

    # -------------------------------------------------- decode (absorbed)
    assert cache is not None and pos is not None
    pos = _decode_pos(pos, x)
    posb = pos.expand(B)[:, None]
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)
    krope_r = apply_rope(krope[:, :, None, :], posb, cfg.rope_theta)[:, :, 0]
    at = pos.reshape(1)
    nckv = _index_copy(cache.ckv, 1, at, ckv.to(cache.ckv.dtype))
    nkrope = _index_copy(cache.krope, 1, at, krope_r.to(cache.krope.dtype))
    Sc = nckv.shape[1]
    # absorb W_uk into the query: q_lat (B, 1, H, R)
    w_uk = p["w_uk"].reshape(R, H, dn)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32), w_uk.to(f32))
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, nckv.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32),
                             nkrope.to(f32))) * scale
    valid = torch.arange(Sc, dtype=torch.int64, device=x.device) <= pos
    scores = torch.where(valid[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, nckv.to(f32))
    w_uv = p["w_uv"].reshape(R, H, dv)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv.to(f32))
    out = out.reshape(B, 1, H * dv)
    out = out.to(x.dtype) @ p["wo"].to(x.dtype)
    return out, MLACache(ckv=nckv, krope=nkrope)
