"""Step functions driven by train.py and serve.py (the reference's
``repro.launch.steps``).

Each takes ``mesh=None``: one device. With a ``DeviceMesh``
(:func:`repro_torch.launch.mesh.make_host_mesh`) the step runs on DTensors
placed by :mod:`repro_torch.distributed.sharding` (parameters, AdamW
moments, batches, caches), under :func:`~repro_torch.distributed.sharding.
on_mesh`, and DTensor inserts the collectives: FSDP+TP training under the
``train`` rules, tensor-parallel serving under the ``serve`` rules, as the
reference's jitted steps run under its mesh.
"""
from __future__ import annotations

import torch

from .. import tree
from ..device import is_dtensor
from ..distributed.sharding import (cache_shardings, distribute, on_mesh,
                                    unshard_dim)
from ..models import decode_step, loss_fn, prefill
from ..optim import adamw

NO_BACKWARD = ("use_kernel=True: the flash attention kernels have no "
               "backward pass (neither has the reference's Pallas kernel), "
               "so a train step takes the plain attention path")


def whole(x):
    """A DTensor as its whole tensor on every rank (a collective); any
    other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def value_and_grad(params, cfg, batch, device=None):
    """(loss, {"ce", "aux"}, grads): the loss of :func:`loss_fn` (plain
    attention) and its gradient with respect to every parameter leaf (zeros
    where a leaf does not reach the loss), shaped as ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, leaves)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, cfg, batch, device=device)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(params, grads)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, use_kernel=False,
                    device=None, mesh=None):
    """``train_step(params, opt_state, batch) -> (new_params, new_opt_state,
    {"loss", "ce", "aux", "grad_norm", "lr"})``: the loss's gradient by
    autograd, then :func:`repro_torch.optim.adamw.apply`. ``use_kernel``
    raises: the flash kernels have no backward pass.

    On a ``mesh`` the parameters, moments and batch are DTensors; each
    gradient is reduced to its parameter's placement before AdamW (the
    global norm sums over every rank's shards), and the metrics come back
    whole on every rank."""
    if use_kernel:
        raise ValueError(NO_BACKWARD)

    def train_step(params, opt_state, batch):
        with on_mesh(mesh):
            loss, metrics, grads = value_and_grad(params, cfg, batch,
                                                  device=device)
            if mesh is not None:
                grads = tree.map_up_to(
                    lambda g, p: g.redistribute(p.device_mesh, p.placements),
                    grads, params)
            new_params, new_opt, om = adamw.apply(opt_cfg, grads,
                                                  opt_state, params)
        out = {"loss": loss, **metrics, **om}
        return new_params, new_opt, {k: whole(v) for k, v in out.items()}
    return train_step


def make_prefill_step(cfg, use_kernel=False, max_len=None, device=None,
                      mesh=None):
    """``prefill_step(params, inputs) -> (last-token logits, caches)``.
    ``max_len`` (not in the reference's step, which sizes the caches to the
    prompt) leaves cache room for the tokens a serve step decodes next. On
    a ``mesh`` the logits are a DTensor and the caches DTensors placed by
    ``cache_shardings``."""
    def prefill_step(params, inputs):
        with on_mesh(mesh):
            logits, caches = prefill(
                params, cfg, tokens=inputs.get("tokens"),
                embeds=inputs.get("embeds"),
                positions3=inputs.get("positions3"), use_kernel=use_kernel,
                max_len=max_len, device=device)
            if mesh is not None:
                caches = distribute(caches, cache_shardings(caches, mesh))
        return logits, caches
    return prefill_step


def make_serve_step(cfg, device=None, mesh=None):
    """``serve_step(params, inputs) -> (next tokens (B,) i32, caches)``:
    greedy argmax over the padded vocabulary, as in the reference."""
    def serve_step(params, inputs):
        with on_mesh(mesh):
            logits, caches = decode_step(
                params, cfg, tokens=inputs.get("tokens"),
                embeds=inputs.get("embeds"), caches=inputs["caches"],
                pos=inputs["pos"], positions3=inputs.get("positions3"),
                device=device)
            nxt = torch.argmax(unshard_dim(logits[:, -1], -1),
                               dim=-1).to(torch.int32)
            if mesh is not None:
                caches = distribute(caches, cache_shardings(caches, mesh))
        return nxt, caches
    return serve_step
