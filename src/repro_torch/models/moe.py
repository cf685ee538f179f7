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
are dropped; it is kept for that. Where the reference annotates the grid
(its expert axis over "model", EP), a DTensor input runs
:func:`moe_on_mesh`: the same routing, sort and grid on each rank's local
tokens, the products of the rank's experts, and a sum of the partial
outputs over the ranks that split them.

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

from ..device import is_dtensor
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


def _shards(cfg, B: int, S: int) -> tuple[int, int]:
    """(ds, T): the capacity grids of ``B * S`` tokens and each one's
    tokens; ``cfg.moe_data_shards`` where it divides the tokens, else 1."""
    ds = cfg.moe_data_shards
    if ds <= 1 or (B * S) % ds:
        ds = 1
    return ds, (B * S) // ds


def _route(xt, router, cfg, C: int):
    """Routing and conflict-group formation of ``xt`` (ds, T, d) into the
    per-shard (E, C) grid: (probs (ds, T, E) f32, eflat (ds, T*k), keep
    (ds, T*k), slot_token (ds, E*C) (T: an empty slot), slot_gate (ds,
    E*C) f32)."""
    ds, T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    logits = xt @ router
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

    # ---- the per-shard (E, C) capacity grid ----
    # slot E*C is the sink of every dropped assignment and is cut off
    token_of = order // k
    slot_token = torch.full((ds, E * C + 1), T, dtype=torch.int64,
                            device=dev).scatter_(1, dest, token_of)[:, :E * C]
    slot_gate = torch.zeros((ds, E * C + 1), dtype=torch.float32,
                            device=dev).scatter_(
        1, dest, gflat.gather(-1, order))[:, :E * C]
    return probs, eflat, keep, slot_token, slot_gate


def _experts(xt, slot_token, slot_gate, wi_gate, wi_up, wo, C: int):
    """Gather, one dense matmul per group and the weighted combine, for the
    experts whose weights are given (E_l of them; ``slot_token`` and
    ``slot_gate`` (ds, E_l*C) their slots): (ds, T, d) f32."""
    ds, T, d = xt.shape
    El = wi_gate.shape[0]
    dev = xt.device
    xt_pad = torch.cat([xt, xt.new_zeros((ds, 1, d))], dim=1)
    h = xt_pad.gather(1, slot_token[..., None].expand(ds, El * C, d))
    h = h.reshape(ds, El, C, d)

    # ---- one dense matmul per group ----
    act = F.silu(torch.einsum("xecd,edf->xecf", h, wi_gate))
    up = torch.einsum("xecd,edf->xecf", h, wi_up)
    oe = torch.einsum("xecf,efd->xecd", act * up, wo)

    # ---- combine (one weighted scatter-add per group member) ----
    contrib = (oe.reshape(ds, El * C, d).to(torch.float32)
               * slot_gate[..., None])
    rows = (slot_token + torch.arange(ds, device=dev)[:, None] * (T + 1))
    y = torch.zeros((ds * (T + 1), d), dtype=torch.float32, device=dev)
    y.index_add_(0, rows.reshape(-1), contrib.reshape(ds * El * C, d))
    return y.reshape(ds, T + 1, d)[:, :T]


def _counts(eflat, E: int):
    """(E,) f32 assignments routed per expert, summed over the shards."""
    return torch.zeros((eflat.shape[0], E), dtype=torch.float32,
                       device=eflat.device).scatter_add_(
        1, eflat, torch.ones_like(eflat, dtype=torch.float32)).sum(0)


def _aux(cnt, frac_prob, E: int):
    """The load-balance aux loss (Switch/GShard form), fleet-wide."""
    frac_tokens = cnt / cnt.sum().clamp_min(1.0)
    return E * torch.sum(frac_tokens * frac_prob)


def moe(p, x, cfg, cap: int | None = None):
    """x: (B, S, d) -> (out (B, S, d), MoEStats). A DTensor ``x`` (a mesh)
    runs :func:`moe_on_mesh`."""
    if is_dtensor(x):
        return moe_on_mesh(p, x, cfg, cap)
    B, S, d = x.shape
    E = cfg.n_experts
    ds, T = _shards(cfg, B, S)
    C = cap or capacity(T, cfg.top_k, E, cfg.capacity_factor)
    xt = x.reshape(ds, T, d)
    probs, eflat, keep, slot_token, slot_gate = _route(
        xt, p["router"].to(x.dtype), cfg, C)
    y = _experts(xt, slot_token, slot_gate, p["wi_gate"].to(x.dtype),
                 p["wi_up"].to(x.dtype), p["wo"].to(x.dtype), C).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xt)
    cnt = _counts(eflat, E)
    aux = _aux(cnt, probs.mean(dim=(0, 1)), E)
    stats = MoEStats(aux_loss=aux, expert_counts=cnt.to(torch.int32),
                     dropped=(~keep).sum().to(torch.int32))
    return y.reshape(B, S, d), stats


# ---------------------------------------------------------------- on a mesh

def _all_reduce(t, groups):
    """``t`` summed over each process group of ``groups`` in turn."""
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        t = funcol.all_reduce(t, "sum", g)
        t = t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t
    return t


class _SumGrad(torch.autograd.Function):
    """The identity forward; the gradient summed over ``groups`` backward:
    the input of work split over those ranks (each rank's part of the
    expert grid)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.groups), None


class _Sum(torch.autograd.Function):
    """A sum over ``groups`` forward (the partial sums of split work); the
    identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x.contiguous(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_on_mesh(p, x, cfg, cap: int | None = None):
    """:func:`moe` on DTensors: the reference's grid, placed explicitly
    where the reference annotates it (``moe.py:82, 112-132`` there).

    The capacity grid is per ``moe_data_shards`` group, as in the
    reference, never per rank: each data rank routes the groups it holds
    (the groups are sharded over the data axes when those divide them and
    the batch, else every rank routes all of them, as the reference's
    replicated grid at ``ds = 1``). Each rank computes its groups' routing,
    sort and grid whole, then the products of the experts its "model" rank
    holds (``moe_spec`` puts "experts" on the model axis) and, where the
    tokens are replicated over the data axes, of its data rank's slice of
    their ``moe_d_ff``; the combine sums those partial outputs over the
    ranks that split the work. Autograd runs through the placements: the
    gates and tokens that enter the split work take their gradients summed
    over the same ranks, each weight's gradient comes back in its own
    placement, and the stats come back whole on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..distributed.sharding import data_axes
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    daxes = data_axes(sizes)
    dsz = math.prod(sizes[a] for a in daxes)
    msz = sizes.get("model", 1)
    B, S, d = x.shape
    E = cfg.n_experts
    ds, T = _shards(cfg, B, S)
    C = cap or capacity(T, cfg.top_k, E, cfg.capacity_factor)
    tok = dsz > 1 and ds % dsz == 0 and B % dsz == 0   # groups over data
    ep = msz > 1 and E % msz == 0                       # experts over model
    ffs = dsz > 1 and not tok and cfg.moe_d_ff % dsz == 0
    rep = Replicate()

    def pl(data, model):
        return tuple(data if n in daxes else model if n == "model" else rep
                     for n in names)

    def local(t, placements, grad_placements):
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)

    groups = ([mesh.get_group("model")] if ep else []) + (
        [mesh.get_group(a) for a in daxes] if ffs else [])
    tok_pl = Shard(0) if tok else rep
    xd = x.redistribute(mesh, pl(tok_pl, rep))
    xl = xd.to_local()
    xt = xl.reshape(-1, T, d)                       # this rank's groups
    probs, eflat, keep, slot_token, slot_gate = _route(
        xt, local(p["router"].to(x.dtype), pl(rep, rep),
                  pl(Partial() if tok else rep, rep)), cfg, C)

    def weight(name, ff_dim):
        split = Shard(ff_dim) if ffs else rep
        e_pl = Shard(0) if ep else rep
        return local(p[name].to(x.dtype), pl(split, e_pl),
                     pl(Partial() if tok else split, e_pl))
    wi_gate, wi_up, wo = (weight("wi_gate", 2), weight("wi_up", 2),
                          weight("wo", 1))
    El = wi_gate.shape[0]
    e0 = mesh.get_coordinate()[names.index("model")] * El if ep else 0
    mine = slice(e0 * C, (e0 + El) * C)
    y = _experts(_SumGrad.apply(xt, groups), slot_token[:, mine],
                 _SumGrad.apply(slot_gate, groups)[:, mine], wi_gate, wi_up,
                 wo, C)
    y = _Sum.apply(y, groups).to(x.dtype).reshape(xl.shape)
    y = DTensor.from_local(y, mesh, pl(tok_pl, rep), run_check=False)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xd)
    dgroups = [mesh.get_group(a) for a in daxes] if tok else []
    cnt = _all_reduce(_counts(eflat, E), dgroups)
    if tok:
        frac_prob = _Sum.apply(probs.sum(dim=(0, 1)), dgroups) / (ds * T)
    else:
        frac_prob = probs.mean(dim=(0, 1))
    dropped = _all_reduce((~keep).sum().to(torch.int32), dgroups)

    def whole(t):
        return DTensor.from_local(t, mesh, pl(rep, rep), run_check=False)
    stats = MoEStats(aux_loss=whole(_aux(cnt, frac_prob, E)),
                     expert_counts=whole(cnt.to(torch.int32)),
                     dropped=whole(dropped))
    return y, stats


class MoEStatsLog:
    """Records the MoEStats of every MoE layer a forward runs (by wrapping
    the transformer block's ``moe`` while active); read after the run."""

    def __init__(self):
        self.stats = []

    def __enter__(self):
        from . import transformer
        self._mod, self._moe = transformer, transformer.moe

        def logged(*args, **kw):
            y, st = self._moe(*args, **kw)
            self.stats.append(st)
            return y, st
        transformer.moe = logged
        return self

    def __exit__(self, *exc):
        self._mod.moe = self._moe
