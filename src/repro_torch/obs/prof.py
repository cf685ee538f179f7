"""Per-stage step profiler: where each engine iteration's wall time goes.

The port of ``repro.obs.prof``. Attribution works by *stage ablation*: for
every stage in ``engine.PROF_STAGES`` a step variant replaces that stage's
compute by its stand-in (``_make_step_events(..., ablate={stage})``), and
its steady-state wall per iteration, on the *same* warmed ``SimState``, is
differenced against the full step's:

    cost(stage) ~= us_per_iter(full) - us_per_iter(ablated)

Under a designated no-op config each ablated step equals the full one leaf
for leaf (tests/test_torch_prof.py), so the difference is the stage's
compute, not a different run. The step never writes into its input, so every
variant starts from the same state without a copy. Negative differences
(noise) clamp to zero and the unattributed remainder is the ``other`` row,
so the fractions sum to 1.

On the card an eager step is mostly host dispatch, so a stage's cost is
chiefly the torch calls it issues; wall times end in
``torch.cuda.synchronize()``. ``compiles`` counts the step variants built
(``len(stages) + 1``), the reference's executables: eager torch compiles
nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from ..core.lock import engine as _engine
from ..core.lock.engine import (DynParams, EngineConfig, PROF_STAGES,
                                SimState, StaticShape, init_state_dyn,
                                split_config)

# Human-readable note per stage: the config under which its ablation is an
# exact no-op (asserted in tests/test_torch_prof.py), and what compute it
# removes. Keys == engine.PROF_STAGES.
STAGE_NOOPS = {
    "dup_analysis": "exact at txn_len == 1; removes the (T,L,L) pairwise "
                    "dup/last-use scan in gen_txn_lanes",
    "deadlock_walk": "exact when has_detection is off (o2/brook2pl); "
                     "removes the 8-hop waits-for cycle walk",
    "ticket_grant": "exact on a read-only workload (write_ratio=0); "
                    "removes grant masks + FIFO ticket argsort",
    "commit_cursor": "exact on a read-only workload; removes the T*L->R "
                     "segment reductions in _derive",
    "group_hotspot": "exact for protocols without group/hot flags "
                     "(mysql/brook2pl); removes the group-lock, "
                     "group-commit and hotspot-detect branches",
    "tick_charge": "exact on all state except the write-only tb "
                   "accumulator; removes the TickBreakdown scatters",
}
assert set(STAGE_NOOPS) == set(PROF_STAGES)


@dataclasses.dataclass(frozen=True)
class StageCost:
    stage: str
    us_per_iter: float          # attributed cost (clamped >= 0)
    fraction: float             # of the full step; all rows sum to 1.0


@dataclasses.dataclass(frozen=True)
class StepProfile:
    protocol: str
    stat: StaticShape
    us_per_iter: float          # full-step steady-state per-iteration wall
    stages: tuple[StageCost, ...]   # ranked by cost desc, ends with residual
    n_iters: int
    repeats: int
    compiles: int               # step variants built (len(stages) + 1)

    @property
    def dominant(self) -> StageCost:
        """Largest *real* stage (the residual never dominates a report)."""
        real = [s for s in self.stages if s.stage != "other"]
        return max(real, key=lambda s: s.us_per_iter)


def make_iter_runner(stat: StaticShape, dp: DynParams, n_iters: int,
                     ablate: frozenset = frozenset()):
    """A ``SimState -> SimState`` running ``n_iters`` step iterations of
    one config, with no loop condition (the profiler's unit)."""
    step = _engine._make_step(stat, _engine._lanes(dp), ablate=ablate)

    def run(st: SimState) -> SimState:
        s = _engine._unsqueeze(st)
        for _ in range(n_iters):
            s = step(s)
        return _engine.take_lane(s, 0)

    return run


def _sync(st: SimState) -> None:
    if st.g.now.is_cuda:
        torch.cuda.synchronize(st.g.now.device)


def _time_us_per_iter(run, st: SimState, n_iters: int, repeats: int) -> float:
    """Best-of-``repeats`` per-iteration wall, the first call excluded."""
    run(st)
    _sync(st)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run(st)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6 / n_iters


def profile_step(cfg: EngineConfig, *, n_iters: int = 256,
                 warmup_rounds: int = 1, repeats: int = 3,
                 stages: Sequence[str] = PROF_STAGES,
                 device=None) -> StepProfile:
    """Attribute the engine step's per-iteration wall cost to its stages,
    on ``device`` (default: CUDA).

    Builds one step variant per ablation plus the full step, warms a
    steady-state ``SimState`` under the full step (``warmup_rounds`` x
    ``n_iters`` iterations), feeds the *same* state to every variant, and
    differences best-of-``repeats`` ``us_per_iter``. The residual the
    ablations cannot explain is the ``other`` row; fractions sum to 1.
    """
    unknown = set(stages) - set(PROF_STAGES)
    if unknown:
        raise ValueError(f"unknown stages: {sorted(unknown)}")
    stat, dp = split_config(cfg, device=device)
    st0 = init_state_dyn(stat, dp)

    full = make_iter_runner(stat, dp, n_iters)
    n_built = 1
    # warm into steady state so every variant sees live contention, not
    # the all-START first ticks
    warm = st0
    for _ in range(warmup_rounds):
        warm = full(warm)
    _sync(warm)
    full_us = _time_us_per_iter(full, warm, n_iters, repeats)

    costs: dict[str, float] = {}
    for stage in stages:
        run = make_iter_runner(stat, dp, n_iters, ablate=frozenset({stage}))
        n_built += 1
        abl_us = _time_us_per_iter(run, warm, n_iters, repeats)
        costs[stage] = max(full_us - abl_us, 0.0)

    other = max(full_us - sum(costs.values()), 0.0)
    total = sum(costs.values()) + other
    total = total or 1.0        # degenerate all-zero measurement
    ranked = sorted(costs.items(), key=lambda kv: -kv[1])
    rows = tuple(StageCost(k, v, v / total) for k, v in ranked)
    rows += (StageCost("other", other, other / total),)
    return StepProfile(protocol=cfg.protocol.name, stat=stat,
                       us_per_iter=full_us, stages=rows,
                       n_iters=n_iters, repeats=repeats, compiles=n_built)


def rank_table(prof: StepProfile) -> str:
    """Ranked per-stage cost table, one profile per call."""
    s = prof.stat
    head = (f"step profile: {prof.protocol} T={s.n_threads} L={s.txn_len} "
            f"R={s.n_rows}  us_per_iter={prof.us_per_iter:.2f} "
            f"(n_iters={prof.n_iters}, best of {prof.repeats})")
    lines = [head, f"{'stage':<16}{'us/iter':>10}{'fraction':>10}"]
    for row in prof.stages:
        lines.append(f"{row.stage:<16}{row.us_per_iter:>10.3f}"
                     f"{row.fraction:>10.3f}")
    d = prof.dominant
    lines.append(f"dominant: {d.stage} ({d.fraction:.0%} of step)")
    return "\n".join(lines)


def profile_row(name: str, prof: StepProfile) -> str:
    """Benchmark CSV row ``name,us_per_iter,stage=frac;...;dominant=...``."""
    body = ";".join(f"{r.stage}={r.fraction:.4f}" for r in prof.stages)
    return (f"{name},{prof.us_per_iter:.3f},{body};"
            f"dominant={prof.dominant.stage};compiles={prof.compiles}")
