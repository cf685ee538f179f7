"""Plain PyTorch versions of the grouped conflict-update functions."""
from __future__ import annotations

import torch


def segment_sums_ref(seg_ids: torch.Tensor, updates: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """seg_ids: (N,) i32 group index per row (any order; ids outside
    [0, num_groups) are dropped); updates: (N, D). Returns (num_groups, D)
    f32 per-group sums, accumulated in f64 and rounded once, so it stays
    an accuracy reference at any group size."""
    ok = (seg_ids >= 0) & (seg_ids < num_groups)
    upd = torch.where(ok[:, None], updates.to(torch.float64), 0.0)
    out = torch.zeros((num_groups,) + updates.shape[1:], dtype=torch.float64,
                      device=updates.device)
    return out.index_add_(0, torch.where(ok, seg_ids, 0).long(),
                          upd).to(torch.float32)


def grouped_apply_ref(table: torch.Tensor, ids: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """End-to-end oracle: the serialized duplicate-index scatter (what the
    paper calls 2PL); ids outside [0, V) are dropped."""
    ok = (ids >= 0) & (ids < table.shape[0])
    upd = torch.where(ok[:, None], updates.to(table.dtype), 0)
    return table.index_add(0, torch.where(ok, ids, 0).long(), upd)
