"""Mixture-of-Experts with conflict-group dispatch (paper §3.3 adapted), the
reference's ``repro.models.moe``.

Token->expert routing is the MoE instance of the hotspot problem: tokens
"contend" for an expert's weights. The dispatch is the paper's group-locking
schedule on tensors:

  1. stable-sort the (token, k) assignments by expert id — conflict-group
     formation; the sort order is the dependency list;
  2. each group executes as ONE dense batched matmul — the group's members
     ("followers") need no further synchronization;
  3. one gather in / one scatter out per group — the leader's single lock
     acquire/release.

The token axis carries a leading shard dimension (``cfg.moe_data_shards``),
so the capacity grid is per data shard and the axis changes which tokens
are dropped; it is kept for that. The ``annotate`` calls stand where the
reference's do: the identity without a mesh, a DTensor redistribution under
one (:mod:`repro_torch.distributed.sharding`).

Capacity overflow (rank >= C within a group) drops to the residual stream —
the analogue of the timeout abort; :func:`suggest_capacity` is the §4.6.1
dynamic-batch-size analogue (host-side capacity feedback from the
expert-load EMA).

The reference's XLA ops and their torch counterparts: ``lax.top_k`` ->
``torch.topk(sorted=True)``; the stable argsort -> ``torch.argsort(
stable=True)``; the ``associative_scan(maximum)`` of the run starts ->
``torch.cummax``; ``.at[...].set(mode="drop")`` -> a scatter into one sink
slot past ``E*C``, then a slice; the vmapped ``.at[idx].add`` combine ->
``index_add_`` over the (shard, token) rows. The combine's float order
differs from XLA's (atomics on the card), so outputs agree to rounding, and
the routing, counts and drops exactly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import annotate
from .common import spec
from .layers import mlp_spec, mlp


def moe_spec(cfg):
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    s = {
        "router": spec((d, E), ("embed", "experts")),
        "wi_gate": spec((E, d, ff), ("experts", "embed", "mlp"),
                        fan_in_axes=(1,)),
        "wi_up": spec((E, d, ff), ("experts", "embed", "mlp"),
                      fan_in_axes=(1,)),
        "wo": spec((E, ff, d), ("experts", "mlp", "embed"),
                   fan_in_axes=(1,)),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_spec(d, ff * cfg.n_shared_experts)
    return s


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor        # load-balance loss (f32 scalar)
    expert_counts: torch.Tensor   # (E,) int32 assignments routed per expert
    dropped: torch.Tensor         # int32 overflow-dropped assignments


def capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(tokens * top_k * cf / n_experts))
    return max(8, ((c + 7) // 8) * 8)     # rounded up to a multiple of 8


def suggest_capacity(count_ema, top_k: int, slack: float = 1.2) -> int:
    """§4.6.1 dynamic batch size, adapted: next-step capacity from the
    observed per-expert load EMA (host-side; shapes are static per step)."""
    return int(float(count_ema.max()) * slack) + 8


def moe(p, x, cfg, cap: int | None = None):
    """x: (B, S, d) -> (out (B, S, d), MoEStats)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    ds = cfg.moe_data_shards
    if ds <= 1 or (B * S) % ds:
        ds = 1
    T = (B * S) // ds                                  # tokens per shard
    C = cap or capacity(T, k, E, cfg.capacity_factor)

    xt = annotate(x.reshape(ds, T, d), "batch", None, None)
    logits = xt @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1, sorted=True)   # (ds, T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- conflict-group formation (stable sort = dependency order) ----
    eflat = eidx.reshape(ds, T * k)
    gflat = gates.reshape(ds, T * k)
    order = torch.argsort(eflat, dim=-1, stable=True)
    sorted_e = eflat.gather(-1, order)
    is_leader = torch.cat(
        [torch.ones((ds, 1), dtype=torch.bool, device=dev),
         sorted_e[:, 1:] != sorted_e[:, :-1]], dim=-1)
    idx = torch.arange(T * k, device=dev)[None]
    run_start = torch.cummax(
        torch.where(is_leader, idx, 0), dim=-1).values
    rank = idx - run_start                             # position in group
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)   # overflow -> sink

    # ---- gather into the per-shard (E, C) capacity grid ----
    # slot E*C is the sink of every dropped assignment and is cut off
    token_of = order // k
    slot_token = torch.full((ds, E * C + 1), T, dtype=torch.int64,
                            device=dev).scatter_(1, dest, token_of)[:, :E * C]
    slot_gate = torch.zeros((ds, E * C + 1), dtype=torch.float32,
                            device=dev).scatter_(
        1, dest, gflat.gather(-1, order))[:, :E * C]
    xt_pad = torch.cat([xt, xt.new_zeros((ds, 1, d))], dim=1)
    h = xt_pad.gather(1, slot_token[..., None].expand(ds, E * C, d))
    h = annotate(h, "batch", "model", None)       # (ds, E*C, d) pre-grid
    h = annotate(h.reshape(ds, E, C, d), "batch", "model", None, None)

    # ---- one dense matmul per group ----
    act = F.silu(torch.einsum("xecd,edf->xecf", h,
                              p["wi_gate"].to(x.dtype)))
    up = torch.einsum("xecd,edf->xecf", h, p["wi_up"].to(x.dtype))
    oe = torch.einsum("xecf,efd->xecd", act * up, p["wo"].to(x.dtype))
    oe = annotate(oe, "batch", "model", None, None)

    # ---- combine (one weighted scatter-add per group member) ----
    contrib = (oe.reshape(ds, E * C, d).to(torch.float32)
               * slot_gate[..., None])
    contrib = annotate(contrib, "batch", "model", None)
    rows = (slot_token + torch.arange(ds, device=dev)[:, None] * (T + 1))
    y = annotate(torch.zeros((ds, T + 1, d), dtype=torch.float32,
                             device=dev), "batch", None, None)
    y = y.reshape(ds * (T + 1), d)
    y.index_add_(0, rows.reshape(-1), contrib.reshape(ds * E * C, d))
    y = annotate(y.reshape(ds, T + 1, d)[:, :T], "batch", None,
                 None).to(x.dtype)

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xt)

    # load-balance aux loss (Switch/GShard form), fleet-wide
    cnt = torch.zeros((ds, E), dtype=torch.float32, device=dev).scatter_add_(
        1, eflat, torch.ones_like(eflat, dtype=torch.float32)).sum(0)
    frac_tokens = cnt / cnt.sum().clamp_min(1.0)
    frac_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_prob)
    stats = MoEStats(aux_loss=aux, expert_counts=cnt.to(torch.int32),
                     dropped=(~keep).sum().to(torch.int32))
    return y.reshape(B, S, d), stats
