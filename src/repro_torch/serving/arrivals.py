"""Arrival processes for the open-system serving layer.

A copy of ``repro.serving.arrivals`` (numpy only): the same ``seed`` gives
the same arrival ticks, bit for bit, in both packages.

An :class:`ArrivalSchedule` is a named, seeded request-arrival stream: a
sorted array of integer arrival ticks over ``[0, horizon)`` plus the
metadata the analytic layer (``serving.analytic``) and the results store
need to reason about it. Like the drift schedules in ``workload.py``,
schedules are generated eagerly on the host (numpy, seeded) so every
consumer — a serving lane, a repeated run, a test re-deriving the same
stream — sees bit-identical arrival times; nothing here is traced, because
arrivals are *host* events: the serving runner admits them at segment
boundaries and meters the device-side pool through traced credits
(``DynParams.txn_cap``), see DESIGN.md §10.

Kinds:

* :func:`poisson` — homogeneous Poisson(rate); the M/M/c validation
  regime (Thomasian, arXiv:2404.02276).
* :func:`bursty` — on/off modulated Poisson: ``burst_rate`` for a
  ``duty`` fraction of every ``period``, ``base_rate`` otherwise.
* :func:`flash_crowd` — rate step at a fraction of the horizon (the
  serving analogue of the drift schedule of the same name).
* :func:`uniform` — deterministic evenly-spaced arrivals (analysis and
  differential tests).
* :func:`saturating` — every request present at tick 0: the queue never
  empties, the pool never idles, and the open-system path must reproduce
  the closed-loop engine bit-exactly (tests/test_serving.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

TICKS_PER_SEC = 10_000_000  # 1 tick = 0.1us (metrics.TICKS_PER_SEC)


@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """A named request-arrival stream over ``[0, horizon)`` ticks."""
    name: str
    times: np.ndarray           # (N,) sorted int64 arrival ticks
    horizon: int
    seed: int = 0

    def __post_init__(self):
        t = np.asarray(self.times, dtype=np.int64)
        assert (np.diff(t) >= 0).all(), "arrival times must be sorted"
        assert t.size == 0 or (t[0] >= 0 and t[-1] < self.horizon), (
            "arrivals must lie in [0, horizon)")
        object.__setattr__(self, "times", t)

    @property
    def n(self) -> int:
        return int(self.times.size)

    @property
    def offered_tps(self) -> float:
        """Offered load in transactions/second of simulated time."""
        return self.n * TICKS_PER_SEC / max(self.horizon, 1)

    def meta(self) -> dict:
        return {"name": self.name, "n": self.n, "horizon": self.horizon,
                "seed": self.seed, "offered_tps": self.offered_tps}


def _finish(kind: str, times: np.ndarray, horizon: int,
            seed: int) -> ArrivalSchedule:
    times = np.sort(times.astype(np.int64))
    times = times[(times >= 0) & (times < horizon)]
    return ArrivalSchedule(kind, times, int(horizon), int(seed))


def poisson(rate: float, horizon: int, *, seed: int = 0) -> ArrivalSchedule:
    """Homogeneous Poisson arrivals: ``rate`` requests per tick.

    Generated as cumulative exponential gaps (inverse-CDF, float64) and
    floored to integer ticks; same-tick arrivals are legal (the queue
    absorbs them).
    """
    assert rate > 0
    rng = np.random.default_rng(seed)
    # enough gaps to overshoot the horizon w.h.p., then trim
    n_draw = int(rate * horizon * 1.25) + 64
    gaps = rng.exponential(1.0 / rate, size=n_draw)
    t = np.cumsum(gaps)
    while t.size and t[-1] < horizon:    # rare undershoot: extend
        extra = rng.exponential(1.0 / rate, size=n_draw)
        t = np.concatenate([t, t[-1] + np.cumsum(extra)])
    return _finish("poisson", np.floor(t), horizon, seed)


def bursty(base_rate: float, burst_rate: float, horizon: int, *,
           period: int, duty: float = 0.25,
           seed: int = 0) -> ArrivalSchedule:
    """On/off modulated Poisson: ``burst_rate`` during the first ``duty``
    fraction of every ``period`` ticks, ``base_rate`` otherwise."""
    assert 0.0 < duty < 1.0 and period > 0
    rng = np.random.default_rng(seed)
    peak = max(base_rate, burst_rate)
    # thinning: draw at the peak rate, keep per-phase
    n_draw = int(peak * horizon * 1.25) + 64
    t = np.cumsum(rng.exponential(1.0 / peak, size=n_draw))
    t = t[t < horizon]
    in_burst = (t % period) < duty * period
    p_keep = np.where(in_burst, burst_rate / peak, base_rate / peak)
    keep = rng.random(t.size) < p_keep
    return _finish("bursty", np.floor(t[keep]), horizon, seed)


def flash_crowd(base_rate: float, spike_rate: float, horizon: int, *,
                at: float = 0.5, spike_frac: float = 0.25,
                seed: int = 0) -> ArrivalSchedule:
    """Rate step: ``base_rate`` until ``at * horizon``, then
    ``spike_rate`` for ``spike_frac * horizon`` ticks, then base again."""
    rng = np.random.default_rng(seed)
    t0, t1 = int(at * horizon), int((at + spike_frac) * horizon)
    peak = max(base_rate, spike_rate)
    n_draw = int(peak * horizon * 1.25) + 64
    t = np.cumsum(rng.exponential(1.0 / peak, size=n_draw))
    t = t[t < horizon]
    in_spike = (t >= t0) & (t < min(t1, horizon))
    p_keep = np.where(in_spike, spike_rate / peak, base_rate / peak)
    keep = rng.random(t.size) < p_keep
    return _finish("flash_crowd", np.floor(t[keep]), horizon, seed)


def uniform(rate: float, horizon: int, *, seed: int = 0) -> ArrivalSchedule:
    """Deterministic evenly-spaced arrivals at ``rate`` per tick."""
    assert rate > 0
    n = int(rate * horizon)
    t = np.floor(np.arange(n, dtype=np.float64) / rate)
    return _finish("uniform", t, horizon, seed)


def saturating(n: int, horizon: int) -> ArrivalSchedule:
    """All ``n`` requests arrive at tick 0 (the closed-loop limit).

    With ``n`` large enough that the queue outlives the horizon, every
    pool slot always has a next request — the regime where the serving
    path must be bit-identical to closed-loop ``simulate()``.
    """
    return _finish("saturating", np.zeros(n), horizon, 0)
