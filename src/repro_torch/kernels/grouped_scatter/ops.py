"""Hotspot-grouped scatter-apply built on the ``segment_sums`` kernel.

Pipeline (paper §4.1-§4.2 on tensors):
  1. detect hot ids (in-batch conflict count > threshold),
  2. the first ``max_hot`` hot rows (ascending) get a conflict group: a
     group index per update row, the kernel's segment reduction, one
     scatter per group (the leader's single write),
  3. every other update, cold or hot beyond ``max_hot``, goes through the
     native scatter (2PL path).

The reference (``repro.kernels.grouped_scatter.ops``) drops the updates of
hot rows beyond ``max_hot``; here they take the cold path, so the result
equals :func:`grouped_apply_ref` in every case and equals the reference
wherever hot rows <= ``max_hot``.
"""
from __future__ import annotations

import torch

from ...core.group_apply import _drop_add
from ...core.hotspot import batch_counts, DEFAULT_THRESHOLD
from ...device import resolve
from .kernel import segment_sums


def hot_groups(ids: torch.Tensor, num_rows: int,
               threshold: int = DEFAULT_THRESHOLD, max_hot: int = 256
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Conflict groups of one batch: ``hot_rows`` (max_hot,) i32, the first
    ``max_hot`` rows with more than ``threshold`` updates in ascending order
    padded with ``num_rows`` (the order and fill of ``jnp.nonzero(...,
    size=max_hot, fill_value=V)``), and ``gidx`` (N,) i32, each update's
    group or -1. Static sizes, so no step needs the hot count on the host."""
    V = num_rows
    hot_row = batch_counts(ids, V) > threshold                    # (V,)
    cand = torch.where(hot_row, torch.arange(V, device=ids.device,
                                             dtype=torch.int32), V)
    hot_rows = torch.sort(cand).values[:max_hot]
    if hot_rows.shape[0] < max_hot:
        hot_rows = torch.cat([hot_rows, torch.full(
            (max_hot - hot_rows.shape[0],), V, dtype=torch.int32,
            device=ids.device)])
    # group index of each update: position of its row in hot_rows
    gidx = torch.searchsorted(hot_rows, ids)
    grouped = (hot_rows[gidx.clamp(0, max_hot - 1)] == ids) \
        & (ids >= 0) & (ids < V)
    return hot_rows, torch.where(grouped, gidx, -1).to(torch.int32)


def grouped_scatter_apply(table: torch.Tensor, ids: torch.Tensor,
                          updates: torch.Tensor,
                          threshold: int = DEFAULT_THRESHOLD,
                          max_hot: int = 256, device=None) -> torch.Tensor:
    """Apply (ids -> updates) into table rows on ``device`` (default CUDA),
    hot rows via the kernel."""
    dev = resolve(device)
    table = table.to(dev)
    V, D = table.shape
    ids = ids.to(dev).reshape(-1).to(torch.int32)
    updates = updates.to(dev).reshape(-1, D)
    if updates.dtype not in (torch.float32, torch.float16):
        updates = updates.to(torch.float32)
    updates = updates.contiguous()
    hot_rows, gidx = hot_groups(ids, V, threshold, max_hot)

    # ---- ungrouped updates: native scatter (2PL) ----
    out = _drop_add(table, torch.where(gidx >= 0, V, ids), updates)
    # ---- conflict groups: kernel segment reduce, one write per group ----
    sums = segment_sums(gidx, updates, num_groups=max_hot)
    return _drop_add(out, hot_rows, sums)
