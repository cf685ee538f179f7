"""Grouped conflict-update apply — the paper's technique on tensors (§3.3).

Concurrent updates to the same parameter row are the tensor analogue of
hotspot row updates. The three schedules of the paper's Figure 3 map to:

  * 2PL            -> ``scatter_serial``: one scatter per conflicting update
                      (duplicate indices serialize; every update "takes the
                      lock").
  * Bamboo         -> same data movement, earlier visibility: no tensor
                      analogue of *release timing*, so not materialized.
  * group locking  -> ``group_apply``: form conflict groups (stable sort by
                      key = dependency-list order), execute the group's
                      updates serially *inside* the group (a segment
                      reduction over the sorted run — followers need no
                      "lock"), then write once per group (the leader's
                      single acquire/release).

``group_apply`` is the plain PyTorch version; the CUDA segment-sum kernel
lives in ``repro_torch/kernels/grouped_scatter``.

The hybrid path (``hotspot_apply``) applies the paper §4.1/§4.2 policy:
only rows whose in-batch conflict count exceeds the threshold take the
grouped path; cold rows go through the plain scatter (2PL), exactly like
TXSQL reverting to 2PL for non-hotspot rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from .hotspot import batch_counts, DEFAULT_THRESHOLD

IMAX = 2**31 - 1


def _drop_add(table: torch.Tensor, ids: torch.Tensor,
              updates: torch.Tensor) -> torch.Tensor:
    """``table.at[ids].add(updates, mode="drop")``: rows whose id lies
    outside [0, V) are dropped; duplicates accumulate."""
    ok = (ids >= 0) & (ids < table.shape[0])
    upd = updates.to(table.dtype)
    upd = torch.where(ok.view((-1,) + (1,) * (upd.dim() - 1)), upd, 0)
    return table.index_add(0, torch.where(ok, ids, 0).long(), upd)


def scatter_serial(table: torch.Tensor, ids: torch.Tensor,
                   updates: torch.Tensor, device=None) -> torch.Tensor:
    """The 2PL analogue: per-update scatter-add (duplicates serialize)."""
    dev = resolve(device)
    return _drop_add(table.to(dev), ids.to(dev), updates.to(dev))


class Groups(NamedTuple):
    """Conflict-group structure over a batch of updates."""
    order: torch.Tensor        # (N,) stable-sort permutation = update order
    sorted_ids: torch.Tensor   # (N,) ids in group order
    is_leader: torch.Tensor    # (N,) first update of each group
    group_size: torch.Tensor   # (N,) size of the group at leader positions


def form_groups(ids: torch.Tensor) -> Groups:
    """Group conflicting updates; stable order = ``hot_update_order``."""
    ids = ids.reshape(-1)
    sorted_ids, order = torch.sort(ids, stable=True)
    is_leader = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=ids.device),
        sorted_ids[1:] != sorted_ids[:-1]])
    return Groups(order=order, sorted_ids=sorted_ids, is_leader=is_leader,
                  group_size=_run_lengths(is_leader))


def _run_lengths(is_leader: torch.Tensor) -> torch.Tensor:
    """Length of each run, placed at the run's leader position (else 0)."""
    n = is_leader.shape[0]
    idx = torch.arange(n, device=is_leader.device)
    starts = torch.cummax(torch.where(is_leader, idx, 0), 0).values
    # run end = next leader's position - 1 (or n-1), found as a run start
    # in reversed space
    rev = is_leader.flip(0)
    mark = torch.cat([torch.ones((1,), dtype=torch.bool,
                                 device=is_leader.device), rev[:-1]])
    rstarts = torch.cummax(torch.where(mark, idx, 0), 0).values
    ends = (n - 1) - rstarts.flip(0)
    return torch.where(is_leader, ends - starts + 1, 0).to(torch.int32)


def group_apply(table: torch.Tensor, ids: torch.Tensor,
                updates: torch.Tensor, device=None) -> torch.Tensor:
    """Group-locking analogue: sort -> in-group serial reduce -> one write
    per group."""
    dev = resolve(device)
    table, ids = table.to(dev), ids.to(dev).reshape(-1)
    n = ids.shape[0]
    updates = updates.to(dev).reshape((n,) + updates.shape[1:])
    g = form_groups(ids)
    upd_sorted = updates[g.order].to(torch.float32)
    # segment-reduce within groups: followers fold into the leader slot
    seg = torch.cumsum(g.is_leader.to(torch.int64), 0) - 1
    summed = torch.zeros((n,) + upd_sorted.shape[1:], dtype=torch.float32,
                         device=dev).index_add_(0, seg, upd_sorted)
    leader_rows = torch.where(g.is_leader, g.sorted_ids,
                              table.shape[0]).to(torch.int32)
    uniq_ids = torch.full((n,), IMAX, dtype=torch.int32,
                          device=dev).scatter_reduce_(0, seg, leader_rows,
                                                      "amin")
    # one scatter per group (the leader's single lock acquire/release)
    return _drop_add(table, uniq_ids, summed)


def hotspot_apply(table: torch.Tensor, ids: torch.Tensor,
                  updates: torch.Tensor,
                  threshold: int = DEFAULT_THRESHOLD,
                  device=None) -> torch.Tensor:
    """Hybrid TXSQL policy: hot rows take the grouped path, cold rows the
    plain 2PL scatter. Same result, different schedule."""
    dev = resolve(device)
    table, ids = table.to(dev), ids.to(dev).reshape(-1)
    n = ids.shape[0]
    updates = updates.to(dev).reshape((n,) + updates.shape[1:])
    counts = batch_counts(ids, table.shape[0])
    is_hot = counts[ids.clamp(0, table.shape[0] - 1).long()] > threshold
    sentinel = table.shape[0]                   # dropped by _drop_add
    hot_ids = torch.where(is_hot, ids, sentinel)
    cold_ids = torch.where(is_hot, sentinel, ids)
    out = _drop_add(table, cold_ids, updates)
    mask = is_hot.view((-1,) + (1,) * (updates.dim() - 1))
    return group_apply(out, hot_ids, updates * mask.to(updates.dtype),
                       device=dev)
