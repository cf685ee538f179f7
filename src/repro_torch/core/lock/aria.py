"""Aria baseline: deterministic batch OCC (Lu et al., VLDB'20), in PyTorch.

The port of ``repro.core.lock.aria``. Aria needs no tick loop: it executes
fixed batches against a snapshot, then runs a deterministic reservation
check; conflict losers abort and rerun in the next batch. One (group)
commit per batch. Reservation rules (single-version counter rows):

  * WAW: a transaction aborts if any of its write keys is also written by a
    transaction with a smaller batch position (the reservation winner).
  * RAW: a transaction aborts if any of its read keys is written by a
    transaction with a smaller batch position.

With a single-hotspot workload every batch commits exactly one transaction
on the hot key — the flat-but-low TPS curve of the paper's Figure 8.

As in the engine, a pack of G configs runs with a leading lane axis on
every leaf: :class:`AriaDyn` of one config holds host scalars, stacked
(``engine.stack_lanes``) numpy (G,) arrays and (G, R) tables; each lane
loops while ``now < horizon`` (and ``now < until`` when segmented) and is
frozen once it stops. Padded threads (tid >= n_active) generate
transactions but are masked out of reservations, commits and metrics.
Segmented runs never split a batch, so any segmentation replays the
identical batch sequence; every loop iteration advances ``now`` by exactly
:func:`batch_ticks`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ...device import resolve
from .costs import CostModel
from .workload import WorkloadSpec, DynWorkload, dyn_workload, gen_txn_lanes
from .engine import (I32, F32, N_HIST, HIST_THRESHOLDS, StaticShape,
                     _hist_bucket, _keys, _lane_view, _loop, _lsum,
                     _seg_count, _seg_min, _take, _unsqueeze, stack_lanes,
                     take_lane)
from .metrics import SimResult, TICKS_PER_SEC, _np, _pct_from_hist

BARRIER = 50  # per-batch scheduling barrier (ticks)


class AriaState(NamedTuple):
    txn: torch.Tensor        # (T,) per-lane txn counter
    retries: torch.Tensor    # (T,) consecutive aborts of the current txn
    now: torch.Tensor
    commits: torch.Tensor
    aborts: torch.Tensor
    lat_sum: torch.Tensor
    hist: torch.Tensor
    committed_val: torch.Tensor  # (R,)


class AriaMetrics(NamedTuple):
    """The leaves extract_aria reads."""
    now: torch.Tensor
    commits: torch.Tensor
    aborts: torch.Tensor
    lat_sum: torch.Tensor
    hist: torch.Tensor


def metrics_view(s: AriaState) -> AriaMetrics:
    return AriaMetrics(now=s.now, commits=s.commits, aborts=s.aborts,
                       lat_sum=s.lat_sum, hist=s.hist)


@dataclasses.dataclass(frozen=True)
class AriaConfig:
    workload: WorkloadSpec
    costs: CostModel
    n_threads: int
    horizon: int = 2_000_000


class AriaDyn(NamedTuple):
    """Per-config Aria parameters (host scalars; numpy (G,) for a pack)."""
    op_exec: int
    commit_base: int
    sync_lat: int
    horizon: int
    n_active: int
    wl: DynWorkload


def split_aria(cfg: AriaConfig, pad_threads: int | None = None,
               pad_len: int | None = None, device=None
               ) -> tuple[StaticShape, AriaDyn]:
    w, c = cfg.workload, cfg.costs
    T = pad_threads or cfg.n_threads
    L = pad_len or w.txn_len
    assert T >= cfg.n_threads and L >= w.txn_len
    stat = StaticShape(kind=w.kind, n_threads=T, txn_len=L, n_rows=w.n_rows)
    dp = AriaDyn(op_exec=int(c.op_exec), commit_base=int(c.commit_base),
                 sync_lat=int(c.sync_lat), horizon=int(cfg.horizon),
                 n_active=int(cfg.n_threads),
                 wl=dyn_workload(w, resolve(device)))
    return stat, dp


def init_aria_state(stat: StaticShape, device=None) -> AriaState:
    T, R = stat.n_threads, stat.n_rows
    dev = resolve(device)

    def z(shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return AriaState(txn=z((T,)), retries=z((T,)), now=z(()), commits=z(()),
                     aborts=z(()), lat_sum=z((), F32), hist=z((N_HIST,)),
                     committed_val=z((R,)))


def batch_ticks(workload: WorkloadSpec, costs: CostModel) -> int:
    """Host mirror of the per-batch sim-time advance: every Aria loop
    iteration moves ``now`` by exactly this many ticks, so sim-time windows
    convert to iteration counts (the compaction scheduler sizes pause
    targets with it)."""
    return (workload.txn_len * costs.op_exec + BARRIER
            + costs.commit_base + costs.sync_lat)


def _lanes(dp: AriaDyn):
    batched = dp.wl.zcdf.dim() == 2
    G = dp.wl.zcdf.shape[0] if batched else 1
    lp = _lane_view(dp, G, batched, dp.wl.zcdf.device)
    lp.G, lp.dev = G, dp.wl.zcdf.device
    return lp


def _make_batch(stat: StaticShape, lp):
    """Build the per-batch step of a pack (shared by the single-shot and
    segmented loops, so segmented runs replay the identical batches)."""
    T, R, L, G = stat.n_threads, stat.n_rows, stat.txn_len, lp.G
    dev = lp.dev
    tids = torch.arange(T, dtype=I32, device=dev)
    active = (tids < lp.n_active).expand(G, T)
    # active (not padded) txn length sets the batch execution time
    batch_time = (lp.wl.txn_len * lp.op_exec + BARRIER + lp.commit_base
                  + lp.sync_lat)
    bt_lane = batch_time.view(G) if torch.is_tensor(batch_time) \
        else batch_time
    # padded threads (rows) and padded op slots (cols) reserve/read nothing
    txn_len = lp.wl.txn_len
    slot_ok = torch.arange(L, dtype=I32, device=dev) < (
        txn_len[..., None] if torch.is_tensor(txn_len) else txn_len)
    live = active[..., None] & slot_ok
    lane = tids[:, None].expand(G, T, L)
    hist_thr = torch.from_numpy(HIST_THRESHOLDS).to(dev)
    hist_off = torch.arange(G, device=dev)[:, None] * N_HIST

    def batch(s: AriaState) -> AriaState:
        keys, iswr, _, _, _ = gen_txn_lanes(stat.kind, R, L, lp.wl, tids,
                                            s.txn)
        iswr = iswr & live
        kf = _keys(keys, R)
        # reservations: smallest thread id wins each written key; rows no
        # slot writes hold segment_min's INT32_MAX fill
        res_at = _take(_seg_min((lane,), (iswr,), kf, G, R)[0], kf)
        beaten = res_at < lane
        waw = (iswr & beaten).any(dim=2)
        raw = (~iswr & live & beaten).any(dim=2)
        abort = waw | raw
        commit = ~abort & active
        committed_val = s.committed_val + _seg_count(
            (iswr & commit[..., None],), kf, G, R)[0]

        lat = (s.retries + 1) * batch_time
        # the bucket is clipped into [0, N_HIST), so the reference's
        # mode="drop" never drops: the add is masked by commit alone
        hist = s.hist.reshape(-1).scatter_add(
            0, (_hist_bucket(lat, hist_thr) + hist_off).reshape(-1),
            commit.to(I32).reshape(-1)).view(G, N_HIST)
        return AriaState(
            txn=s.txn + commit.to(I32),
            retries=torch.where(commit, 0, s.retries + 1),
            now=s.now + bt_lane,
            commits=s.commits + _lsum(commit),
            aborts=s.aborts + _lsum(abort),
            lat_sum=s.lat_sum + _lsum(torch.where(commit, lat, 0)).to(F32),
            hist=hist,
            committed_val=committed_val,
        )

    return batch


def _run_lanes(stat: StaticShape, dp: AriaDyn, s0: AriaState,
               untils=None) -> AriaState:
    """Whole batches per lane while ``now < horizon`` (and ``now < until``
    per lane when segmented)."""
    lp = _lanes(dp)
    until = None
    if untils is not None:
        until = torch.as_tensor(np.asarray(untils, np.int64).reshape(-1),
                                dtype=I32, device=lp.dev)

    def cond(s: AriaState) -> torch.Tensor:
        h = lp.horizon.view(-1) if torch.is_tensor(lp.horizon) \
            else lp.horizon
        running = s.now < h
        return running if until is None else running & (s.now < until)

    return _loop(cond, _make_batch(stat, lp), s0)


def _run_dyn(stat: StaticShape, dp: AriaDyn) -> AriaState:
    s0 = _unsqueeze(init_aria_state(stat, dp.wl.zcdf.device))
    return take_lane(_run_lanes(stat, dp, s0), 0)


def _run_batch(stat: StaticShape, dps: AriaDyn) -> AriaState:
    """Run G stacked Aria configs as one pack."""
    s0 = init_aria_state(stat, dps.wl.zcdf.device)
    return _run_lanes(stat, dps, stack_lanes([s0] * dps.wl.zcdf.shape[0]))


def _run_seg_dyn(stat: StaticShape, dp: AriaDyn, s0: AriaState,
                 until) -> AriaState:
    """Resume ``s0`` and run whole batches until ``now`` reaches ``until``
    (or the horizon); bit-exact with the single-shot run at any
    segmentation."""
    return take_lane(_run_lanes(stat, dp, _unsqueeze(s0), [int(until)]), 0)


def _run_seg_batch(stat: StaticShape, dps: AriaDyn, s0s: AriaState,
                   untils) -> AriaState:
    """Segmented analogue of :func:`_run_batch`: G resumable lanes, each
    paused at its own target (``untils``, G ints or a (G,) tensor)."""
    if torch.is_tensor(untils):
        untils = untils.tolist()
    return _run_lanes(stat, dps, s0s, untils)


def simulate_aria(workload: WorkloadSpec, n_threads: int,
                  costs: CostModel | None = None,
                  horizon: int = 2_000_000, device=None) -> AriaState:
    """Run Aria over one workload on ``device`` (default: CUDA)."""
    stat, dp = split_aria(AriaConfig(workload, costs or CostModel(),
                                     n_threads, horizon), device=device)
    return _run_dyn(stat, dp)


def extract_aria(n_threads: int, s) -> SimResult:
    """Metrics of one Aria run (an ``AriaState`` or ``AriaMetrics``, with
    tensor or numpy leaves)."""
    commits = int(s.commits)
    aborts = int(s.aborts)
    now = max(int(s.now), 1)
    sim_s = now / TICKS_PER_SEC
    hist = _np(s.hist)
    return SimResult(
        protocol="aria", n_threads=n_threads, commits=commits,
        user_aborts=0, forced_aborts=aborts, lock_ops=0,
        sim_seconds=sim_s, tps=commits / sim_s,
        mean_latency_us=(float(s.lat_sum) / commits / 10.0) if commits else 0,
        p95_latency_us=_pct_from_hist(hist, 0.95),
        p99_latency_us=_pct_from_hist(hist, 0.99),
        lock_wait_frac=0.0, cpu_util=1.0,
        abort_rate=aborts / max(commits + aborts, 1),
        iters=0,
    )
