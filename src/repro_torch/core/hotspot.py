"""Hotspot detection for skewed-update keys (§4.1 adapted).

The paper promotes a row to *hot* when its lock wait queue exceeds a
threshold (rule of thumb: 32) and demotes it when the queue drains. The
training-side analogue: a parameter row (embedding row, expert) is hot when
the number of conflicting updates targeting it in the current batch exceeds
the threshold; an EMA across steps plays the role of the background sweeper
(promotion persists across steps; demotion when traffic drains).

All functions are pure and work on the device their tensors lie on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve

DEFAULT_THRESHOLD = 32  # the paper's rule-of-thumb queue length


def batch_counts(ids: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Per-key update counts in this batch ("queue length" per row); ids
    outside [0, num_keys) are dropped."""
    ids = ids.reshape(-1)
    ok = (ids >= 0) & (ids < num_keys)
    return torch.zeros((num_keys,), dtype=torch.int32,
                       device=ids.device).scatter_add_(
        0, torch.where(ok, ids, 0).long(), ok.to(torch.int32))


def detect_hot(ids: torch.Tensor, num_keys: int,
               threshold: int = DEFAULT_THRESHOLD) -> torch.Tensor:
    """One-shot hotspot mask: key has > threshold conflicting updates."""
    return batch_counts(ids, num_keys) > threshold


def detect_hot_queue(queue_depth: torch.Tensor,
                     threshold: int = DEFAULT_THRESHOLD) -> torch.Tensor:
    """One-shot hotspot mask from OBSERVED per-lock queue depths.

    The same ``> threshold`` promote rule the lock engine applies to its
    derived wait-queue length every iteration (``engine._hotspot_on``),
    applied to a measured depth vector — e.g. the ``CA_QMAX`` lane of the
    engine's per-record contention accumulator (``Globals.ca``), which
    records each row's peak observed queue depth. This is what unifies
    the batch-side detector with the engine's: both are thresholdings of
    a queue-depth observable, differing only in where the observable
    comes from.
    """
    return torch.as_tensor(queue_depth) > threshold


class HotspotState(NamedTuple):
    """EMA of per-key contention, carried across steps."""
    ema: torch.Tensor          # (num_keys,) f32
    hot: torch.Tensor          # (num_keys,) bool
    step: torch.Tensor         # () i32


def init_hotspot(num_keys: int, device=None) -> HotspotState:
    dev = resolve(device)
    return HotspotState(
        ema=torch.zeros((num_keys,), dtype=torch.float32, device=dev),
        hot=torch.zeros((num_keys,), dtype=torch.bool, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def update_hotspot_queue(state: HotspotState, queue_depth: torch.Tensor,
                         threshold: int = DEFAULT_THRESHOLD,
                         decay: float = 0.9,
                         demote_below: float = 1.0) -> HotspotState:
    """Advance the detector one step on an observed queue-depth vector.

    Promote when the observed depth crosses ``threshold`` (the paper's
    queue-length-32 rule); demote when the depth EMA drains below
    ``demote_below`` (the background sweeper). This is the shared core:
    :func:`update_hotspot` feeds it batch update counts, the engine
    telemetry path feeds it per-segment observed depths.
    """
    counts = torch.as_tensor(queue_depth).to(torch.float32)
    ema = decay * state.ema + (1.0 - decay) * counts
    promote = counts > threshold
    demote = state.hot & (ema < demote_below)
    return HotspotState(
        ema=ema,
        hot=(state.hot | promote) & ~demote,
        step=state.step + 1,
    )


def update_hotspot(state: HotspotState, ids: torch.Tensor,
                   threshold: int = DEFAULT_THRESHOLD,
                   decay: float = 0.9,
                   demote_below: float = 1.0) -> HotspotState:
    """Advance the detector one step (promotion + sweeper demotion)."""
    return update_hotspot_queue(
        state, batch_counts(ids, state.ema.shape[0]),
        threshold=threshold, decay=decay, demote_below=demote_below)
