"""Governor policies: re-decide the lock protocol between run segments.

A copy of ``repro.adaptive.governor`` (host code, no RNG: every policy is
deterministic) over the port's cost tables and metrics, so the same
telemetry gives the same decisions in both packages.

The engine exposes resumable segments (``engine.run_segment``) whose
boundaries deliver telemetry — counter deltas (throughput, aborts, waits;
``metrics.extract_segment``) plus instantaneous contention state
(``engine.SegSnapshot``). A *policy* maps that history to the **preset**
(a named ``ProtocolParams`` configuration) to run for the next segment.
Every protocol flag and cost is a ``DynParams`` value, so acting on a
decision costs nothing: the next segment simply runs with the new values
(DESIGN.md §7).

Three policy families (a preset-table governor):

* :class:`FixedPolicy` — a pinned preset; the baselines in every figure.
* :class:`QueueRulePolicy` — the paper's hotspot rule (§4.1) lifted to the
  governor: a deep single-row queue means group locking wins; a full-stall
  wait pattern (every thread blocked, CPU idle, no aborts) is the
  detection-free deadlock signature, so fall back to strict 2PL; a calm
  system takes the cheapest lock path. Thresholds are in protocol-agnostic
  units (fractions of the active thread count).
* :class:`EpsilonGreedyPolicy` — model-free search over the preset table:
  bootstrap every arm once, exploit the best recent estimate, re-explore
  when the incumbent's throughput collapses; estimates decay with age, and
  a collapse taints same-*family* arms (protocols sharing the lock-grant
  machinery stall together — o2 and group are indistinguishable absent hot
  rows), so the governor does not waste a probe confirming a correlated
  collapse.
"""
from __future__ import annotations

import dataclasses

from ..core.lock.costs import ProtocolParams, protocol_params
from ..core.lock.metrics import SimResult

# ---------------------------------------------------------------------------
# preset table
# ---------------------------------------------------------------------------
# name -> (base protocol, overrides, family). Families group presets whose
# grant machinery behaves identically when no row is promoted hot: a
# detection-free stall observed on one member is evidence about the others.

PRESETS: dict[str, tuple[str, dict, str]] = {
    "mysql": ("mysql", {}, "detect"),
    "o1": ("o1", {}, "detect"),
    "o2": ("o2", {}, "queue"),
    "group": ("group", {}, "queue"),
    "bamboo": ("bamboo", {}, "early"),
    # knob variants (hill-climbing targets): eager promotion / batch sizing
    "group_eager": ("group", {"hot_threshold": 8}, "queue"),
    "group_batch4": ("group", {"batch_size": 4}, "queue"),
    "group_batch32": ("group", {"batch_size": 32}, "queue"),
    # Brook-2PL (chop-ordered, deadlock-free; family "brook"). The
    # deadlock-freedom claim covers transactions GENERATED under the
    # chop order — a FixedPolicy("brook2pl") run from segment 0 never
    # stalls, aborts, or pays detection. Switching INTO brook2pl
    # mid-run is different: in-flight transactions generated under the
    # previous preset's (un)ordering can already hold locks in a cycle,
    # and pure brook has NO resolver (no detection walk, no timeouts) —
    # an inherited cycle would stall the run until the horizon, so
    # ``run_governed`` REJECTS such switches loudly (see
    # :func:`switch_safe`). Policies that switch protocols use
    # `brook_guard` (wait timeout re-armed as the residual resolver;
    # zero false timeouts on brook-generated waits and recovery from an
    # inherited cycle are both asserted in tests/test_adaptive.py).
    # `brook_hold` keeps ordered acquisition but holds to commit
    # (strict 2PL without deadlocks, for heavy injected-abort mixes
    # where early readers are wasted work).
    # The guard timeout here is the context-free fallback (10 ms): an
    # order of magnitude above any legitimate chop-ordered wait at
    # governed thread counts (T<=128: ~10k ticks of queued holders), so
    # brook traffic never falsely times out. Runners that know their
    # segmentation pass horizon/n_segments to ``preset_params`` and get
    # :func:`guard_timeout` instead — half a segment, clamped — so a
    # cycle inherited at the LAST segment boundary still resolves before
    # the horizon (the fixed 100k guard could outlive a late switch-in's
    # remaining run; regression-tested in tests/test_adaptive.py).
    "brook2pl": ("brook2pl", {}, "brook"),
    "brook_hold": ("brook2pl", {"per_op_release": False}, "brook"),
    "brook_guard": ("brook2pl", {"wait_timeout": 100_000,
                                 "commit_wait_timeout": 100_000}, "brook"),
}

DEFAULT_ARMS = ("o2", "group", "mysql")


# guard-timeout derivation bounds (ticks). The floor keeps the guard an
# order of magnitude above legitimate chop-ordered waits at governed
# thread counts (no false timeouts on brook-generated traffic, asserted
# in tests/test_adaptive.py); the cap keeps it at the old fixed value —
# segmenting more coarsely than 200k-tick segments gains nothing because
# inherited-cycle stalls longer than that were already resolvable.
GUARD_FLOOR = 20_000
GUARD_CAP = 100_000


def guard_timeout(horizon: int, n_segments: int) -> int:
    """Derived residual-resolver timeout: half a governed segment,
    clamped to [GUARD_FLOOR, GUARD_CAP]. Half, so a cycle inherited at a
    segment boundary — the only place switches happen — resolves with
    segment time to spare even when the switch lands on the LAST
    boundary."""
    seg = int(horizon) // max(int(n_segments), 1)
    return max(GUARD_FLOOR, min(GUARD_CAP, seg // 2))


def preset_params(name: str, *, horizon: int | None = None,
                  n_segments: int | None = None) -> ProtocolParams:
    """Resolve a preset. When the caller supplies its segmentation
    (``horizon`` + ``n_segments``), presets that re-arm the wait timeout
    as their residual deadlock resolver (an explicit positive
    ``wait_timeout`` override — brook_guard) get :func:`guard_timeout`
    instead of the fixed fallback. Presets whose timeouts are protocol
    semantics (mysql's 500k default, brook2pl's hard 0) are untouched."""
    proto, over, _ = PRESETS[name]
    if (horizon is not None and n_segments is not None
            and over.get("wait_timeout", 0) > 0):
        g = guard_timeout(horizon, n_segments)
        over = dict(over, wait_timeout=g, commit_wait_timeout=g)
    return protocol_params(proto, **over)


def preset_family(name: str) -> str:
    return PRESETS[name][2]


def switch_safe(name: str) -> bool:
    """Can a governed run adopt this preset MID-RUN (segment k > 0)?

    A preset with no dynamic deadlock resolver (no detection walk, no
    wait timeout) relies on every in-flight transaction having been
    generated under its chop order — true from segment 0 or when the
    previous preset already ordered acquisitions, false after a switch
    from an unordered preset, where inherited out-of-order holders can
    cycle unresolvably (DESIGN.md §9.2). Derived from the params, not a
    hand-list, so knob variants inherit the right answer.
    """
    p = preset_params(name)
    return bool(p.has_detection or p.wait_timeout > 0)


# ---------------------------------------------------------------------------
# segment records (what a policy sees)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentRecord:
    """One governed segment: window metrics + end-of-segment state."""
    index: int
    t0: int                 # segment entry sim-time (ticks)
    t1: int                 # segment exit sim-time
    preset: str             # preset that ran this segment
    metrics: SimResult      # counter deltas over [t0, t1]
    max_qlen: int           # longest row wait queue at t1
    n_hot: int              # promoted-hot rows at t1
    n_live: int             # live tickets at t1
    n_waiting: int          # threads in a wait phase at t1
    # distribution observables at t1 (obs layer, engine.SegSnapshot):
    # log2-bucket histograms of row wait-queue depth (all rows) and live-
    # ticket occupancy (hot rows only). Defaulted empty so pre-PR7 record
    # construction sites / pickles keep working.
    wait_hist: tuple = ()
    occ_hist: tuple = ()

    def as_json(self) -> dict:
        """Compact time-series entry for the results store (v3 schema)."""
        m = self.metrics
        return {
            "index": self.index, "t0": self.t0, "t1": self.t1,
            "preset": self.preset, "tps": m.tps, "commits": m.commits,
            "aborts": m.user_aborts + m.forced_aborts,
            "abort_rate": m.abort_rate, "lock_wait_frac": m.lock_wait_frac,
            "cpu_util": m.cpu_util, "max_qlen": self.max_qlen,
            "n_hot": self.n_hot, "n_live": self.n_live,
            "n_waiting": self.n_waiting,
            # v3 additions: per-window TickBreakdown (ticks per bin,
            # branches summed; conserves to pad_T * (t1 - t0)) and the
            # end-of-segment distribution histograms
            "breakdown": dict(m.breakdown),
            "wait_hist": list(self.wait_hist),
            "occ_hist": list(self.occ_hist),
            # v4 addition: per-window top-K contended records from the
            # contention accumulator delta (empty when EngineConfig.attrib
            # is off); wait_ticks summed over ALL rows equals
            # breakdown["lock_wait"] exactly (conservation, DESIGN.md §14)
            "hotspots": [dict(h) for h in getattr(m, "hotspots", [])],
        }


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

class Policy:
    """Decides the preset for segment ``k`` from the segment history.

    Stateful: one instance governs one cell. ``reset`` is called by the
    runner before segment 0 with the cell's active thread count.
    """
    name = "policy"

    def reset(self, n_threads: int) -> None:
        self.n_threads = n_threads

    def decide(self, k: int, history: list[SegmentRecord]) -> str:
        raise NotImplementedError


class FixedPolicy(Policy):
    """Always the same preset — the single-protocol baselines."""

    def __init__(self, preset: str):
        assert preset in PRESETS, preset
        self.preset = preset
        self.name = f"fixed:{preset}"

    def decide(self, k, history):
        return self.preset


class QueueRulePolicy(Policy):
    """The paper's queue-threshold rule as a governor (§4.1, extended).

    Reads only the last segment's telemetry:

    1. hotspot — ``max_qlen >= promote_frac * T`` AND the waiters are
       *concentrated* on that queue (``max_qlen >= conc_frac *
       n_waiting``): group locking's territory. Concentration is what
       separates a hot row (migration probe: qlen 120 of 122 waiting)
       from a deadlock pile-up whose queues are long but dispersed
       (flash-crowd probe: qlen 25 of 64 waiting).
    2. stall — ``n_waiting >= stall_frac * T`` without case 1: most
       threads blocked across dispersed queues is the detection-free
       deadlock-stall signature (measured: a forming stall shows ~0.65T
       waiting one segment before the full absorbing stall): run the
       detection preset. Detection protocols under heavy contention also
       sit here, which keeps them put — this branch only *moves to*
       detection.
    3. calm (``lock_wait_frac <= calm_wait`` and ``n_waiting`` tiny) —
       no contention to manage: cheapest lock path.
    4. otherwise keep the incumbent (hysteresis; ambiguous mid states —
       e.g. 2PL quietly absorbing a deadlock-prone mix — stay put).
    """

    def __init__(self, *, hot: str = "group", detect: str = "mysql",
                 calm: str = "o2", promote_frac: float = 0.5,
                 conc_frac: float = 0.75, stall_frac: float = 0.6,
                 calm_wait: float = 0.05, calm_nwait_frac: float = 0.06,
                 name: str = "rule"):
        for p in (hot, detect, calm):
            assert p in PRESETS, p
        self.hot, self.detect, self.calm = hot, detect, calm
        self.promote_frac = promote_frac
        self.conc_frac = conc_frac
        self.stall_frac = stall_frac
        self.calm_wait = calm_wait
        self.calm_nwait_frac = calm_nwait_frac
        self.name = name

    def decide(self, k, history):
        if not history:
            return self.calm
        r = history[-1]
        T = self.n_threads
        if (r.max_qlen >= self.promote_frac * T
                and r.n_waiting > 0
                and r.max_qlen >= self.conc_frac * r.n_waiting):
            return self.hot
        if r.n_waiting >= self.stall_frac * T:
            return self.detect
        if (r.metrics.lock_wait_frac <= self.calm_wait
                and r.n_waiting <= max(2.0, self.calm_nwait_frac * T)):
            return self.calm
        return r.preset


class EpsilonGreedyPolicy(Policy):
    """Bootstrap-explore / exploit / drop-triggered re-explore over arms.

    Estimates are each arm's most recent observed segment throughput,
    decayed by ``decay`` per segment of age (stale knowledge fades; the
    incumbent, refreshed every segment, is compared at face value). When
    the incumbent's throughput falls below ``drop_frac`` times its recent
    best (a window of its own in-regime observations), the regime has
    shifted: all estimates are invalidated and re-probed best-first —
    except same-family arms, which inherit the collapsed observation
    (a detection-free stall on one queue-family member indicts them all).
    ``explore_every > 0`` adds scheduled re-probes of the stalest arm
    (the classic epsilon term; off by default — decayed exploitation plus
    drop-triggered re-exploration covers drifting regimes deterministically).
    """

    def __init__(self, arms=DEFAULT_ARMS, *, decay: float = 0.85,
                 drop_frac: float = 0.5, window: int = 3,
                 explore_every: int = 0, name: str = "greedy"):
        assert len(arms) >= 1
        for a in arms:
            assert a in PRESETS, a
        self.arms = tuple(arms)
        self.decay = decay
        self.drop_frac = drop_frac
        self.window = window
        self.explore_every = explore_every
        self.name = name

    def reset(self, n_threads):
        super().reset(n_threads)
        self.est: dict[str, float] = {}     # arm -> last observed tps
        self.seen: dict[str, int] = {}      # arm -> segment of observation
        self.valid: dict[str, bool] = {}    # arm -> observed this regime?
        self.recent: dict[str, list] = {a: [] for a in self.arms}

    def _ingest(self, r: SegmentRecord):
        arm, tps = r.preset, r.metrics.tps
        if arm not in self.arms:
            return
        win = self.recent[arm]
        wmax = max(win) if win else 0.0
        if self.valid.get(arm) and wmax > 0 and tps < self.drop_frac * wmax:
            # regime shift under the incumbent: invalidate everything,
            # propagating the collapse to the incumbent's family.
            fam = preset_family(arm)
            for a in self.arms:
                self.valid[a] = False
                if a != arm and preset_family(a) == fam:
                    self.est[a] = tps
                    self.seen[a] = r.index
                    self.valid[a] = True
                    self.recent[a] = [tps]
            self.recent[arm] = []
        self.est[arm] = tps
        self.seen[arm] = r.index
        self.valid[arm] = True
        self.recent[arm] = (self.recent[arm] + [tps])[-self.window:]

    def decide(self, k, history):
        if history:
            self._ingest(history[-1])
        # bootstrap / re-probe: unobserved or invalidated arms, best-first
        pending = [a for a in self.arms if a not in self.est]
        if pending:
            return pending[0]
        stale = [a for a in self.arms if not self.valid.get(a)]
        if stale:
            return max(stale, key=lambda a: self.est[a])
        if self.explore_every and k > 0 and k % self.explore_every == 0:
            return min(self.arms, key=lambda a: self.seen[a])
        return max(self.arms,
                   key=lambda a: self.est[a]
                   * self.decay ** max(0, k - self.seen[a] - 1))
