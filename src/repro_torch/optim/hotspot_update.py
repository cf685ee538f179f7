"""Hotspot-grouped embedding gradient: the paper's technique on the
training hot path (the reference's ``repro.optim.hotspot_update``).

The embedding backward is a scatter-add of per-token cotangents into vocab
rows with Zipf-distributed indices: the hotspot-update workload.
:func:`grouped_embed` computes it with the conflict-group schedule of
:func:`repro_torch.core.group_apply` (stable sort, in-group segment
reduction, one write per distinct row) into an f32 zero table, where
:func:`serial_embed` takes autograd's own indexing backward; same values in
f32, another schedule.
"""
from __future__ import annotations

import torch

from ..core.group_apply import group_apply


class _GroupedEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.tshape, ctx.tdtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, ct):
        (tokens,) = ctx.saved_tensors
        ids = tokens.reshape(-1)
        upd = ct.reshape(-1, ctx.tshape[-1]).to(torch.float32)
        zero = torch.zeros(ctx.tshape, dtype=torch.float32, device=ct.device)
        # conflict-group apply: sort + segment-reduce + one write per group
        dtable = group_apply(zero, ids, upd, device=ct.device)
        return dtable.to(ctx.tdtype), None


def grouped_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` whose gradient goes through ``group_apply``. Runs
    where ``table`` lies."""
    return _GroupedEmbed.apply(table, tokens)


def serial_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Baseline: autograd's indexing backward (an accumulating scatter)."""
    return table[tokens]
