"""Block assembly and the layer-group loop (the reference's
``repro.models.transformer``, dense GQA blocks only).

The reference compiles each ``LayerGroup = (unit, repeats)`` as one
``lax.scan`` over parameters stacked on a leading "layers" axis. Here a
group's parameters are a list with one dict per repeat, and
:func:`group_apply_layers` is a Python loop over it; caches are lists of
per-layer ``KVCache``s alongside.
"""
from __future__ import annotations

import torch

from ..device import resolve
from .attention import gqa_spec, gqa_attend, gqa_cache_len, KVCache
from .layers import rmsnorm_spec, rmsnorm, mlp_spec, mlp


# --------------------------------------------------------------- specs

def block_spec(cfg, kind):
    mixer, mlp_kind = kind
    if mixer != "global" or mlp_kind not in ("dense", "none"):
        raise NotImplementedError(
            f"block {kind!r}: only global GQA mixers with a dense MLP are "
            "ported")
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d), "attn": gqa_spec(cfg)}
    if mlp_kind != "none":
        s["ln2"] = rmsnorm_spec(d)
        s["mlp"] = mlp_spec(d, cfg.d_ff)
    return s


def group_spec(cfg, unit, repeats):
    """One list entry per repeat (the reference stacks them instead)."""
    return {f"u{i}": [block_spec(cfg, kind) for _ in range(repeats)]
            for i, kind in enumerate(unit)}


def lm_block_specs(cfg):
    return {f"g{gi}": group_spec(cfg, unit, reps)
            for gi, (unit, reps) in enumerate(cfg.layout)}


# --------------------------------------------------------------- caches

def lm_init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                  device=None):
    """Zeroed decode caches for the whole model on ``device`` (default
    CUDA): ``{g: {u: [KVCache per repeat]}}``."""
    dev = resolve(device)

    def layer(kind):
        if kind[0] != "global":
            raise NotImplementedError(f"cache for {kind!r} is not ported")
        sh = (batch, gqa_cache_len(cfg, kind[0], seq_len), cfg.n_kv_heads,
              cfg.hd)
        return KVCache(k=torch.zeros(sh, dtype=dtype, device=dev),
                       v=torch.zeros(sh, dtype=dtype, device=dev))

    return {f"g{gi}": {f"u{i}": [layer(kind) for _ in range(reps)]
                       for i, kind in enumerate(unit)}
            for gi, (unit, reps) in enumerate(cfg.layout)}


# --------------------------------------------------------------- apply

def block_apply(p, x, cfg, kind, mode, cache=None, pos=None,
                positions3=None, use_kernel=False, max_len=None):
    """One block. Returns (x, new_cache, aux_loss); aux_loss is 0.0 (no MoE
    layers are ported)."""
    mixer, mlp_kind = kind
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, ncache = gqa_attend(p["attn"], h, cfg, mixer, mode, cache=cache,
                             pos=pos, positions3=positions3,
                             use_kernel=use_kernel, max_len=max_len)
    x = x + out
    if mlp_kind != "none":
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h)
    return x, ncache, 0.0


def group_apply_layers(p, x, cfg, unit, mode, caches=None, pos=None,
                       positions3=None, use_kernel=False, max_len=None):
    """Run one layer group: ``p`` and ``caches`` are ``{u: [per repeat]}``.

    Returns (x, new_caches|None, aux_sum)."""
    has_cache = mode in ("prefill", "decode")
    n_reps = len(p["u0"])
    aux_sum = 0.0
    new_caches = {f"u{i}": [] for i in range(len(unit))}
    for r in range(n_reps):
        for i, kind in enumerate(unit):
            c = caches[f"u{i}"][r] if caches is not None else None
            x, nc, aux = block_apply(p[f"u{i}"][r], x, cfg, kind, mode,
                                     cache=c, pos=pos, positions3=positions3,
                                     use_kernel=use_kernel, max_len=max_len)
            new_caches[f"u{i}"].append(nc)
            aux_sum = aux_sum + aux
    return x, (new_caches if has_cache else None), aux_sum
