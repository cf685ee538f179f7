"""Block assembly and the layer-group loop (the reference's
``repro.models.transformer``).

A block is ``(mixer, mlp)``: mixer ``global`` | ``local`` (GQA), ``mla``,
``rglru`` or ``ssd``; mlp ``dense`` | ``moe`` | ``moe+dense`` | ``none``.
The reference compiles each ``LayerGroup = (unit, repeats)`` as one
``lax.scan`` over parameters stacked on a leading "layers" axis. Here a
group's parameters are a list with one dict per repeat, and
:func:`group_apply_layers` is a Python loop over it; caches are lists of
per-layer caches alongside (``KVCache``, ``MLACache``, ``RGLRUState``,
``SSDState``). With ``remat`` in ``train`` mode each repeat of the unit runs
under a non-reentrant ``torch.utils.checkpoint``: only its input is kept,
and the backward pass recomputes the rest (the reference's
``jax.checkpoint(nothing_saveable)`` unit body).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..distributed.sharding import annotate, seq_gather, seq_scatter
from .attention import (gqa_spec, gqa_attend, gqa_cache_len, KVCache,
                        mla_spec, mla_attend, MLACache)
from .layers import rmsnorm_spec, rmsnorm, mlp_spec, mlp
from .moe import moe_spec, moe
from .rglru import rglru_spec, rglru, RGLRUState
from .ssd import ssd_spec, ssd, SSDState

MIXERS = ("global", "local", "mla", "rglru", "ssd")
MLPS = ("dense", "moe", "moe+dense", "none")


# --------------------------------------------------------------- specs

def block_spec(cfg, kind):
    mixer, mlp_kind = kind
    if mixer not in MIXERS or mlp_kind not in MLPS:
        raise ValueError(f"unknown layer kind {kind!r}")
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d)}
    if mixer in ("global", "local"):
        s["attn"] = gqa_spec(cfg)
    elif mixer == "mla":
        s["attn"] = mla_spec(cfg)
    elif mixer == "rglru":
        s["attn"] = rglru_spec(cfg)
    else:
        s["attn"] = ssd_spec(cfg)
    if mlp_kind != "none":
        s["ln2"] = rmsnorm_spec(d)
        if mlp_kind in ("dense", "moe+dense"):
            s["mlp"] = mlp_spec(d, cfg.d_ff)
        if mlp_kind in ("moe", "moe+dense"):
            s["moe"] = moe_spec(cfg)
    return s


def group_spec(cfg, unit, repeats):
    """One list entry per repeat (the reference stacks them instead)."""
    return {f"u{i}": [block_spec(cfg, kind) for _ in range(repeats)]
            for i, kind in enumerate(unit)}


def lm_block_specs(cfg):
    return {f"g{gi}": group_spec(cfg, unit, reps)
            for gi, (unit, reps) in enumerate(cfg.layout)}


# --------------------------------------------------------------- caches

def block_cache_shape(cfg, kind, batch: int, seq_len: int, dtype):
    """One layer's decode cache as meta tensors (shapes and dtypes, no
    storage). Attention caches take ``dtype``; the RG-LRU and SSD states
    are always f32, as in the reference."""
    mixer = kind[0]

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    if mixer in ("global", "local"):
        sh = (batch, gqa_cache_len(cfg, mixer, seq_len), cfg.n_kv_heads,
              cfg.hd)
        return KVCache(k=meta(sh), v=meta(sh))
    if mixer == "mla":
        return MLACache(ckv=meta((batch, seq_len, cfg.kv_lora_rank)),
                        krope=meta((batch, seq_len, cfg.qk_rope_dim)))
    f32 = torch.float32
    if mixer == "rglru":
        w = cfg.lru_width
        return RGLRUState(h=meta((batch, w), f32),
                          conv=meta((batch, cfg.conv_width - 1, w), f32))
    if mixer == "ssd":
        return SSDState(
            h=meta((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                   f32),
            conv=meta((batch, cfg.conv_width - 1,
                       cfg.d_inner + 2 * cfg.ssm_state), f32))
    raise ValueError(f"unknown mixer {mixer!r}")


def lm_cache_shapes(cfg, batch: int, seq_len: int, dtype=torch.bfloat16):
    """The whole model's cache as meta tensors, in the reference's layout:
    ``{g: {u: cache}}``, each leaf with a leading axis of the group's
    repeats."""
    def stack(c, n):
        return type(c)(*(torch.empty((n,) + x.shape, dtype=x.dtype,
                                     device="meta") for x in c))

    return {f"g{gi}": {f"u{i}": stack(block_cache_shape(
        cfg, kind, batch, seq_len, dtype), reps)
        for i, kind in enumerate(unit)}
        for gi, (unit, reps) in enumerate(cfg.layout)}


def lm_init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                  device=None):
    """Zeroed decode caches for the whole model on ``device`` (default
    CUDA), from :func:`lm_cache_shapes`: ``{g: {u: [cache per repeat]}}``."""
    dev = resolve(device)
    return {g: {u: [type(c)(*(torch.zeros(x.shape[1:], dtype=x.dtype,
                                          device=dev) for x in c))
                    for _ in range(c[0].shape[0])]
                for u, c in units.items()}
            for g, units in lm_cache_shapes(cfg, batch, seq_len,
                                            dtype).items()}


# --------------------------------------------------------------- apply

def block_apply(p, x, cfg, kind, mode, cache=None, pos=None,
                positions3=None, use_kernel=False, max_len=None):
    """One block. Returns (x, new_cache, aux_loss f32 scalar). On a mesh
    ``x`` is the residual's sequence shard: each norm runs on it (per
    token), the mixer and the MLP take its output gathered along the
    sequence (:func:`seq_gather`), and their outputs come back to the
    shard (:func:`seq_scatter`)."""
    mixer, mlp_kind = kind
    h = seq_gather(rmsnorm(p["ln1"], x, cfg.norm_eps))
    if mixer in ("global", "local"):
        out, ncache = gqa_attend(p["attn"], h, cfg, mixer, mode, cache=cache,
                                 pos=pos, positions3=positions3,
                                 use_kernel=use_kernel, max_len=max_len)
    elif mixer == "mla":
        out, ncache = mla_attend(p["attn"], h, cfg, mode, cache=cache,
                                 pos=pos, max_len=max_len)
    elif mixer == "rglru":
        out, ncache = rglru(p["attn"], h, cfg, mode, state=cache)
    else:
        out, ncache = ssd(p["attn"], h, cfg, mode, state=cache)
    x = x + seq_scatter(out, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mlp_kind != "none":
        h = seq_gather(rmsnorm(p["ln2"], x, cfg.norm_eps))
        y = mlp(p["mlp"], h) if "mlp" in p else None
        if "moe" in p:
            ym, stats = moe(p["moe"], h, cfg)
            aux = aux + stats.aux_loss
            y = ym if y is None else y + ym
        x = x + seq_scatter(y, x)
    return x, ncache, aux


def group_apply_layers(p, x, cfg, unit, mode, caches=None, pos=None,
                       positions3=None, use_kernel=False, remat=True,
                       max_len=None):
    """Run one layer group: ``p`` and ``caches`` are ``{u: [per repeat]}``.
    Under a mesh the residual ``x`` enters each repeat of the unit
    sequence-parallel, annotated ("batch", "model", None) as in the
    reference, so the input a remat checkpoint keeps is each rank's
    sequence shard.

    Returns (x, new_caches|None, aux_sum f32 scalar)."""
    has_cache = mode in ("prefill", "decode")
    n_reps = len(p["u0"])
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {f"u{i}": [] for i in range(len(unit))}

    def unit_body(x, r):
        x = annotate(x, "batch", "model", None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ncs = []
        for i, kind in enumerate(unit):
            c = caches[f"u{i}"][r] if caches is not None else None
            x, nc, a = block_apply(p[f"u{i}"][r], x, cfg, kind, mode,
                                   cache=c, pos=pos, positions3=positions3,
                                   use_kernel=use_kernel, max_len=max_len)
            ncs.append(nc)
            aux = aux + a
        return x, ncs, aux

    recompute = remat and mode == "train" and torch.is_grad_enabled()
    for r in range(n_reps):
        if recompute:
            x, ncs, aux = checkpoint(unit_body, x, r, use_reentrant=False)
        else:
            x, ncs, aux = unit_body(x, r)
        for i, nc in enumerate(ncs):
            new_caches[f"u{i}"].append(nc)
        aux_sum = aux_sum + aux
    return x, (new_caches if has_cache else None), aux_sum
