"""Language model: embed -> layer groups -> head, in modes ``train``,
``prefill`` and ``decode``, and the training loss (the reference's
``repro.models.lm``).

In ``train`` mode :func:`forward` returns the full logits, or the post-norm
hidden states when ``cfg.loss_chunk`` is set: :func:`chunked_cross_entropy`
then builds the logits one sequence chunk at a time, recomputing each chunk
in the backward pass, so the (B, S, V) logits never exist.

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
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..distributed.sharding import (annotate, place_batch, seq_gather,
                                    unshard_dim)
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
    """Embed, run the layer groups, norm and project. Under a mesh the
    residual is annotated ("batch", "model", None) after the embedding, as
    in the reference: sharded over the data axes along the batch and over
    "model" along the sequence (where the axes divide them) through every
    unit; the final norm runs on that shard, and the hidden states are
    gathered along the sequence before the last position is taken, the
    head projects, or the chunked CE takes them. Returns
    :class:`LMOutput`."""
    dev = _param_device(params, resolve(device))
    if pos is not None:
        pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    act_dtype = getattr(torch, cfg.act_dtype)
    if cfg.embed_inputs:
        x = embed(params["embed"],
                  place_batch(torch.as_tensor(tokens, device=dev)))
    else:
        x = place_batch(torch.as_tensor(embeds, device=dev))
    x = annotate(x.to(act_dtype), "batch", "model", None)
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
            remat=cfg.remat, max_len=max_len)
        new_caches[gkey] = nc
        aux_total = aux_total + aux

    # the norm on the sequence shard, then whole rows for the head
    x = seq_gather(rmsnorm(params["ln_f"], x, cfg.norm_eps))
    if mode == "prefill":
        x = x[:, -1:]          # only the last position feeds decoding
    if mode == "train" and cfg.loss_chunk:
        # chunked-CE path: the loss builds the logits chunk by chunk
        return LMOutput(logits=x, caches=None, aux_loss=aux_total)
    logits = unembed(params["head"], x)
    logits = annotate(logits, *(("batch",) + (None,) * (logits.dim() - 2)
                                + ("model",)))
    return LMOutput(logits=logits,
                    caches=new_caches if mode != "train" else None,
                    aux_loss=aux_total)


def _ce_sums(logits, labels, vocab: int, zloss: float = 0.0):
    """Masked-sum CE in f32: (sum of the per-position losses, the number of
    positions counted). logits (..., V_padded); labels (...) integer, those
    below 0 masked out; padded vocabulary columns are masked at -1e30."""
    V = logits.shape[-1]
    # a DTensor's vocab shards are gathered first: the gather of the label
    # columns below needs whole rows
    lg = unshard_dim(logits.to(torch.float32), -1)
    if V > vocab:
        pad = torch.arange(V, device=lg.device) < vocab
        lg = torch.where(pad, lg, -1e30)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    if zloss:
        nll = nll + zloss * lse.square()
    mask = (labels >= 0).to(torch.float32)
    return (nll * mask).sum(), mask.sum()


def cross_entropy(logits, labels, vocab: int, zloss: float = 0.0):
    tot, n = _ce_sums(logits, labels, vocab, zloss)
    return tot / n.clamp(min=1.0)


def chunked_cross_entropy(head_params, x, labels, cfg):
    """Sequence-chunked CE over hidden states x (B, S, d): the logits exist
    one (B, loss_chunk, V) chunk at a time, in the forward pass and, through
    a non-reentrant checkpoint of each chunk, in the backward pass."""
    B, S, _ = x.shape
    c = cfg.loss_chunk
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of loss_chunk {c}")

    def body(xc, lc):
        logits = unembed(head_params, xc)
        logits = annotate(logits, *(("batch",) + (None,) * (logits.dim() - 2)
                                    + ("model",)))
        return _ce_sums(logits, lc, cfg.vocab, cfg.zloss)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(S // c):
        sl = slice(j * c, (j + 1) * c)
        nll, cnt = checkpoint(body, x[:, sl], labels[:, sl],
                              use_reentrant=False)
        tot, n = tot + nll, n + cnt
    return tot / n.clamp(min=1.0)


def loss_fn(params, cfg, batch, use_kernel=False, device=None):
    """batch: dict with 'tokens'/'embeds', 'labels', optional 'positions3'.

    Returns (loss, {"ce", "aux"}): CE plus 0.01 times the MoE load-balance
    loss."""
    out = forward(params, cfg, tokens=batch.get("tokens"),
                  embeds=batch.get("embeds"),
                  positions3=batch.get("positions3"), mode="train",
                  use_kernel=use_kernel, device=device)
    labels = torch.as_tensor(batch["labels"], device=out.logits.device)
    if cfg.loss_chunk:
        ce = chunked_cross_entropy(params["head"], out.logits, labels, cfg)
    else:
        ce = cross_entropy(out.logits, labels, cfg.vocab, cfg.zloss)
    loss = ce + 0.01 * out.aux_loss
    return loss, {"ce": ce, "aux": out.aux_loss}


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
