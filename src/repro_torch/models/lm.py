"""Language model: embed -> layer groups -> head, in modes ``train`` (full
logits), ``prefill`` and ``decode`` (the reference's ``repro.models.lm``
without the loss; training is not ported yet).

``cfg.embed_inputs=False`` architectures (musicgen, qwen2-vl) take
precomputed frame/patch embeddings (``embeds`` (B, S, d)) instead of token
ids; musicgen emits ``n_codebooks`` parallel heads (logits (..., K, V));
qwen2-vl takes the M-RoPE position streams ``positions3`` (3, B, S).

The entry points take ``device=None`` (the CUDA card; see
:mod:`repro_torch.device`) and expect the parameters to lie there
(:func:`repro_torch.models.common.init_params` with the same ``device``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..device import resolve
from .layers import (embed_spec, embed, unembed_spec, unembed,
                     rmsnorm_spec, rmsnorm)
from .transformer import lm_block_specs, group_apply_layers


def lm_spec(cfg):
    s = {}
    if cfg.embed_inputs:
        s["embed"] = embed_spec(cfg.padded_vocab, cfg.d_model)
    s["blocks"] = lm_block_specs(cfg)
    s["ln_f"] = rmsnorm_spec(cfg.d_model)
    s["head"] = unembed_spec(cfg.d_model, cfg.padded_vocab,
                             max(cfg.n_codebooks, 1))
    return s


class LMOutput(NamedTuple):
    logits: torch.Tensor
    caches: Any
    aux_loss: torch.Tensor     # f32 scalar: the MoE layers' summed
                               # load-balance loss (0 without MoE)


def _param_device(params, dev: torch.device) -> torch.device:
    """Where the parameters lie, after checking that it is ``dev``."""
    pdev = params["ln_f"]["scale"].device
    if pdev.type != dev.type or dev.index not in (None, pdev.index):
        raise ValueError(f"parameters lie on {pdev}, not on {dev}; "
                         f"initialise them with device={str(dev)!r}")
    return pdev


def forward(params, cfg, tokens=None, embeds=None, mode="train",
            caches=None, pos=None, positions3=None, use_kernel=False,
            max_len=None, device=None) -> LMOutput:
    dev = _param_device(params, resolve(device))
    if pos is not None:
        pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    act_dtype = getattr(torch, cfg.act_dtype)
    if cfg.embed_inputs:
        x = embed(params["embed"], torch.as_tensor(tokens, device=dev))
    else:
        x = torch.as_tensor(embeds, device=dev)
    x = x.to(act_dtype)
    if positions3 is not None:
        positions3 = torch.as_tensor(positions3, device=dev)

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches = {}
    for gi, (unit, reps) in enumerate(cfg.layout):
        gkey = f"g{gi}"
        gcache = caches[gkey] if caches is not None else None
        x, nc, aux = group_apply_layers(
            params["blocks"][gkey], x, cfg, unit, mode, caches=gcache,
            pos=pos, positions3=positions3, use_kernel=use_kernel,
            max_len=max_len)
        new_caches[gkey] = nc
        aux_total = aux_total + aux

    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if mode == "prefill":
        x = x[:, -1:]          # only the last position feeds decoding
    logits = unembed(params["head"], x)
    return LMOutput(logits=logits,
                    caches=new_caches if mode != "train" else None,
                    aux_loss=aux_total)


def prefill(params, cfg, tokens=None, embeds=None, positions3=None,
            use_kernel=False, max_len=None, device=None):
    """Build caches from a prompt; returns (last-token logits, caches).

    ``max_len`` preallocates cache capacity for subsequent decode steps.
    """
    out = forward(params, cfg, tokens=tokens, embeds=embeds,
                  positions3=positions3, mode="prefill",
                  use_kernel=use_kernel, max_len=max_len, device=device)
    return out.logits[:, -1:], out.caches


def decode_step(params, cfg, tokens=None, embeds=None, caches=None,
                pos=None, positions3=None, device=None):
    """One decode step. tokens: (B, 1). Returns (logits, new caches)."""
    out = forward(params, cfg, tokens=tokens, embeds=embeds, caches=caches,
                  pos=pos, positions3=positions3, mode="decode",
                  device=device)
    return out.logits, out.caches
