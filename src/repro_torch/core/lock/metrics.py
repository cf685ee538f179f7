"""Result extraction for CC-engine simulations.

Two modes:

* whole-run: :func:`extract` / :func:`extract_globals` on a final state.
* per-segment (delta): every metric in ``Globals`` is a monotone counter
  (or a histogram of counters), so the metrics of any time window are the
  elementwise difference of its boundary snapshots — :func:`delta_globals`
  builds that difference as a synthetic ``Globals`` whose ``now`` is the
  window length, and :func:`extract_segment` feeds it through the same
  extraction path, keeping whole-run and per-segment numbers structurally
  identical (a 1-segment window reproduces the whole-run result exactly).

Extraction is numpy over host copies of the leaves, so it takes port
states on any device (and numpy snapshots alike).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import (SimState, N_HIST, HIST_BASE, TB_NAMES, CA_NAMES,
                     CA_WAIT, CA_GRANTS)

TICKS_PER_SEC = 10_000_000  # 1 tick = 0.1us


def _np(x) -> np.ndarray:
    """A leaf as a host numpy array (tensor on any device, or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class SimResult:
    protocol: str
    n_threads: int
    commits: int
    user_aborts: int
    forced_aborts: int
    lock_ops: int
    sim_seconds: float
    tps: float
    mean_latency_us: float
    p95_latency_us: float
    p99_latency_us: float
    lock_wait_frac: float       # share of txn time spent lock-waiting
    cpu_util: float             # busy thread-ticks / (T * ticks)
    abort_rate: float
    iters: int
    # deadlock-detection ticks paid on the grant path (0 for detection-
    # free protocols; brook2pl's acceptance metric).
    dd_ticks: int = 0
    # TickBreakdown (obs layer, DESIGN.md §11): thread-tick attribution
    # {bin_name: ticks} summed over branches, and the hot-branch share
    # alone. sum(breakdown.values()) == T * now ticks (conservation).
    breakdown: dict = dataclasses.field(default_factory=dict)
    breakdown_hot: dict = dataclasses.field(default_factory=dict)
    # Per-record contention summary (obs layer, DESIGN.md §14): top-K rows
    # of ``Globals.ca`` by wait ticks, as {"row": r, "wait_ticks": ...,
    # "grants": ..., "timeouts": ..., "victims": ..., "queue_sum": ...,
    # "queue_max": ...} dicts. Empty when attribution is off (the
    # accumulator is all-zero).
    hotspots: list = dataclasses.field(default_factory=list)

    def row(self) -> str:
        return (f"{self.protocol},{self.n_threads},{self.tps:.0f},"
                f"{self.mean_latency_us:.1f},{self.p95_latency_us:.1f},"
                f"{self.abort_rate:.4f},{self.lock_ops},"
                f"{self.cpu_util:.3f},{self.lock_wait_frac:.3f}")


def _pct_from_hist(hist: np.ndarray, q: float) -> float:
    total = hist.sum()
    if total == 0:
        return 0.0
    target = q * total
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, target))
    b = min(b, N_HIST - 1)
    # bucket b holds latencies in [base^b - 1, base^(b+1) - 1) ticks
    ticks = HIST_BASE ** (b + 0.5)
    return ticks / 10.0  # -> us


def hotspot_rows(ca, top_k: int = 8) -> list[dict]:
    """Top-``top_k`` contended records from a ``Globals.ca`` accumulator
    (or a :func:`delta_globals` window of one), ranked by wait ticks with
    grant count as the tiebreak. Rows with no recorded activity are
    dropped, so attribution-off runs summarize to ``[]``."""
    ca = _np(ca)
    active = ca.any(axis=0)
    if not active.any():
        return []
    rank = np.lexsort((-ca[CA_GRANTS], -ca[CA_WAIT]))[:top_k]
    return [
        {"row": int(r), **{k: int(ca[i, r]) for i, k in enumerate(CA_NAMES)}}
        for r in rank if active[r]
    ]


def extract(protocol: str, n_threads: int, s: SimState) -> SimResult:
    return extract_globals(protocol, n_threads, s.g)


def extract_globals(protocol: str, n_threads: int, g,
                    lane: int | None = None) -> SimResult:
    """Extract from the Globals leaf alone (all metrics live there) — the
    sweep runner uses this to avoid hauling full states off device.
    ``lane`` picks one lane of a pack's Globals (a leading lane axis on
    every leaf); only that lane's leaves are copied to the host."""
    if lane is not None:
        g = type(g)(*(v[lane] for v in g))
    g = type(g)(*(_np(v) for v in g))
    commits = int(g.commits)
    aborts = int(g.user_aborts) + int(g.forced_aborts)
    now = max(int(g.now), 1)
    sim_s = now / TICKS_PER_SEC
    hist = g.hist
    tb = g.tb
    breakdown = {k: int(tb[:, i].sum()) for i, k in enumerate(TB_NAMES)}
    breakdown_hot = {k: int(tb[1, i]) for i, k in enumerate(TB_NAMES)}
    lat_mean = (float(g.lat_sum) / commits / 10.0) if commits else 0.0
    total_lat_ticks = max(float(g.lat_sum), 1.0)
    return SimResult(
        protocol=protocol,
        n_threads=n_threads,
        commits=commits,
        user_aborts=int(g.user_aborts),
        forced_aborts=int(g.forced_aborts),
        lock_ops=int(g.lock_ops),
        sim_seconds=sim_s,
        tps=commits / sim_s,
        mean_latency_us=lat_mean,
        p95_latency_us=_pct_from_hist(hist, 0.95),
        p99_latency_us=_pct_from_hist(hist, 0.99),
        lock_wait_frac=float(g.wait_ticks) / total_lat_ticks,
        cpu_util=float(g.busy_ticks) / (n_threads * now),
        abort_rate=aborts / max(commits + aborts, 1),
        iters=int(g.iters),
        dd_ticks=int(g.dd_ticks),
        breakdown=breakdown,
        breakdown_hot=breakdown_hot,
        hotspots=hotspot_rows(g.ca),
    )


def delta_globals(g0, g1):
    """Counter delta across a segment ``[g0, g1]`` as a synthetic Globals.

    Every field of ``Globals`` is a monotone counter over the run, so the
    segment's contribution is ``g1 - g0`` fieldwise; ``now`` becomes the
    window length, which makes the result directly consumable by
    :func:`extract_globals` (tps/cpu_util divide by the window). Works on
    tensors and on host (numpy) snapshots alike. One caveat: the
    ``ca[CA_QMAX]`` lane of the contention accumulator is a running max,
    not a counter — its delta is the window's *peak increase* (0 unless
    the row set a new all-run queue-depth record inside the window), not
    the window max; every other ca lane differences exactly.
    """
    return type(g1)(*(b - a for a, b in zip(g0, g1)))


def extract_segment(protocol: str, n_threads: int, g0, g1) -> SimResult:
    """Per-segment metrics from boundary Globals snapshots (see above)."""
    return extract_globals(protocol, n_threads, delta_globals(g0, g1))


CSV_HEADER = ("protocol,threads,tps,mean_lat_us,p95_lat_us,abort_rate,"
              "lock_ops,cpu_util,lock_wait_frac")



def bench_row(name: str, wall_us: float, r: SimResult) -> str:
    """The benchmark harness's ``name,us_per_call,derived`` row — shared by
    the per-config path and the sweep path (``repro_torch.sweep.summarize``)
    so the two dialects can't drift apart."""
    return (f"{name},{wall_us:.0f},"
            f"tps={r.tps:.0f};p95us={r.p95_latency_us:.0f}"
            f";abort={r.abort_rate:.3f};lockops={r.lock_ops}"
            f";cpu={r.cpu_util:.2f};waitfrac={r.lock_wait_frac:.2f}")
