"""Open-system serving loop over the segmented lock engine, in PyTorch.

The port of ``repro.serving.runner``. A :class:`ServeCell` is one served
pool: an arrival schedule (``serving.arrivals``), a workload, ``n_threads``
device-resident engine slots, and an admission policy. :func:`serve` runs
every cell as a sequence of resumable engine segments
(``run_packed_segment``, the same substrate the governed runner rides) and
layers the open-system mechanics on the host, at segment boundaries only:

* **admission** — arrivals with time <= the boundary enter a host FIFO
  queue, bounded by ``queue_cap`` (``admission`` picks what happens at
  the bound: reject the newcomer, shed the oldest, or wait = unbounded).
* **dispatch** — queued requests become per-thread *credits*: thread
  ``t``'s transaction quota (``DynParams.txn_cap[t]``) is raised by one per
  assigned request (round-robin, least-outstanding first, bounded by
  ``max_outstanding`` per slot). The engine halts a slot the instant its
  quota is exhausted, so between boundaries the device runs exactly the
  dispatched work — the pool is closed-loop *within* a segment, open
  *across* them.
* **retire** — completions are read off the device as per-thread ``txn``
  counter deltas (a committed or user-aborted transaction is a completed
  request; forced aborts retry and complete later) and matched FIFO
  against the thread's assigned arrival ticks: response time = boundary
  observation time − arrival tick. Freed slots (quota exhausted → phase
  HALT) are revived by flipping HALT→START for any slot holding fresh
  credits — outstanding == 0 at a boundary *implies* HALT (the quota
  check sits on the same iteration that completes the final credited
  txn), so revival needs no phase readback.

With a saturating schedule and unbounded per-slot credit the quota never
binds and the device-side state evolution equals closed-loop
``simulate()``, ``iters`` aside — the parity anchor for everything else
this layer reports. See DESIGN.md §10.

Governed serving: give a cell a ``policy`` (``repro_torch.adaptive``) and
it re-decides the preset each boundary from the same
:class:`SegmentRecord` history the governed runner feeds it; the
resolver-free-preset switch rule (brook, DESIGN.md §9.2) is enforced here
identically. Workloads don't drift under serving, so only the
ordered-prefix rule can trip (the chop rank table is static).

What differs from the reference:

* **Device.** ``device=None`` is the CUDA card; the credit vector
  (``cap_vector``) and the revived phases live on the lanes' device, so a
  pack never leaves it.
* **Response histogram.** The response ticks are known on the host (in
  ``retire``), so ``_hist_add`` buckets them there, with numpy's
  ``searchsorted`` over the engine's threshold table
  (:data:`HIST_THRESHOLDS`, the buckets of ``engine._hist_bucket``). The
  reference adds them on its device, padded to a power of two only to
  bound its compiled shapes.
* **Host reads.** At each boundary a group's ``Globals``, ``txn`` counters
  and snapshots come to the host together (``sweep.runner.to_host``).
* **Compile accounting.** The reference registers ``_hist_add`` with
  ``repro.obs.compile_log`` and counts its segment executables; the port
  compiles nothing (eager torch) and has no ``obs`` layer yet, so there is
  no registration and ``ServeResults.n_compiles`` is 0.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable

import numpy as np
import torch

from ..core.lock import engine as _engine
from ..core.lock.costs import CostModel
from ..core.lock.engine import (EngineConfig, HIST_THRESHOLDS, I32, N_HIST,
                                take_lane)
from ..core.lock.metrics import (SimResult, TICKS_PER_SEC, _pct_from_hist,
                                 extract_globals)
from ..core.lock.workload import WorkloadSpec
from ..device import resolve
from ..sweep.grid import SweepPoint
from ..sweep.runner import (BucketInfo, SweepResults, MIN_T_BUCKET,
                            _auto_chunk, _pow2ceil, run_packed_segment,
                            to_host)
from ..adaptive.governor import (PRESETS, Policy, SegmentRecord,
                                 preset_params, switch_safe)
from ..adaptive.runner import segment_record

from .arrivals import ArrivalSchedule

ADMISSIONS = ("reject", "shed", "wait")


@dataclasses.dataclass(frozen=True)
class ServeCell:
    """One served engine pool: arrivals in, responses + telemetry out."""
    name: str
    schedule: ArrivalSchedule
    workload: WorkloadSpec
    n_threads: int                  # pool slots (device threads)
    preset: str = "mysql"           # governor preset (PRESETS name)
    policy: Policy | None = None    # optional: re-decide preset per segment
    costs: CostModel = CostModel()
    p_abort: float = 0.0
    queue_cap: int = 256            # backpressure bound (ignored by "wait")
    admission: str = "reject"       # reject newcomer | shed oldest | wait
    max_outstanding: int = 2        # dispatched-but-unfinished cap per slot
    sla_us: float = 0.0             # response-time SLA (0: no SLA account)
    attrib: bool = False            # per-record contention accumulator

    def __post_init__(self):
        assert self.preset in PRESETS, self.preset
        assert self.admission in ADMISSIONS, self.admission
        assert self.max_outstanding >= 1
        assert self.n_threads >= 1

    def label(self) -> str:
        return self.policy.name if self.policy else self.preset


@dataclasses.dataclass(frozen=True)
class ServingRecord:
    """One serving boundary: engine window metrics + queue accounting."""
    index: int
    t0: int                 # window entry sim-time (ticks)
    t1: int                 # window exit sim-time (observation point)
    preset: str
    metrics: SimResult      # engine counter deltas over [t0, t1]
    arrived: int            # arrivals admitted-or-refused this window
    rejected: int
    shed: int
    completed: int          # responses observed at t1
    qlen: int               # queue length after dispatch at t1
    in_flight: int          # dispatched, not yet completed, at t1
    p50_us: float           # response-time percentiles of this window's
    p99_us: float           # completions (0 when none completed)
    p999_us: float
    sla_miss: int           # window completions past the SLA
    max_qlen: int           # engine snapshot telemetry at t1 (row queue —
    n_waiting: int          # not the arrival queue) for governor parity

    def as_json(self) -> dict:
        m = self.metrics
        return {
            "index": self.index, "t0": self.t0, "t1": self.t1,
            "preset": self.preset, "tps": m.tps, "commits": m.commits,
            "abort_rate": m.abort_rate, "lock_wait_frac": m.lock_wait_frac,
            "cpu_util": m.cpu_util, "arrived": self.arrived,
            "rejected": self.rejected, "shed": self.shed,
            "completed": self.completed, "qlen": self.qlen,
            "in_flight": self.in_flight, "p50_us": self.p50_us,
            "p99_us": self.p99_us, "p999_us": self.p999_us,
            "sla_miss": self.sla_miss, "max_qlen": self.max_qlen,
            "n_waiting": self.n_waiting,
            # v3 addition: per-window TickBreakdown (ticks per bin,
            # branches summed; conserves to pad_T * (t1 - t0))
            "breakdown": dict(m.breakdown),
            # v4 addition: per-window top-K contended records (empty when
            # ServeCell.attrib is off) — see adaptive.SegmentRecord
            "hotspots": [dict(h) for h in getattr(m, "hotspots", [])],
        }


@dataclasses.dataclass(frozen=True)
class ServingResult:
    """Whole-run open-system summary for one cell."""
    name: str
    label: str
    schedule: dict              # ArrivalSchedule.meta()
    offered_tps: float
    completed_tps: float        # responses (commits + user aborts) per sec
    goodput_tps: float          # engine commits per sec
    arrived: int
    rejected: int
    shed: int
    dispatched: int
    completed: int
    qlen_end: int
    in_flight_end: int
    mean_resp_us: float
    p50_us: float
    p99_us: float
    p999_us: float
    max_us: float
    sla_us: float
    sla_miss: int
    sla_miss_frac: float        # misses / completions (0 when no SLA)
    utilization: float          # engine cpu_util over the whole run
    engine: SimResult           # closed-loop-style engine metrics

    def as_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["engine"] = dataclasses.asdict(self.engine)
        return d


@dataclasses.dataclass
class ServeResults(SweepResults):
    """SweepResults (store/bench compatible) + per-cell serving summaries.

    ``states`` (``serve(..., return_states=True)``) maps cell name to the
    final device ``SimState`` — the differential tests compare its leaves
    bit-for-bit against closed-loop ``simulate()``.
    """
    serving: dict[str, ServingResult] = dataclasses.field(
        default_factory=dict)
    states: dict = dataclasses.field(default_factory=dict)
    # raw response times in us per cell, only when serve(...,
    # keep_responses=True) — the parity check for the histogram
    # percentiles; empty by default (horizon-scale runs must not haul
    # O(completions) floats to host)
    responses: dict = dataclasses.field(default_factory=dict)


def _cell_config(cell: ServeCell, preset: str,
                 seg_ticks: int | None = None) -> EngineConfig:
    horizon = cell.schedule.horizon
    n_segments = max(1, horizon // seg_ticks) if seg_ticks else None
    return EngineConfig(
        protocol=preset_params(preset, horizon=horizon,
                               n_segments=n_segments),
        costs=cell.costs,
        workload=cell.workload, n_threads=cell.n_threads,
        horizon=horizon, p_abort=cell.p_abort, attrib=cell.attrib)


def _pctl(resp_us: list, q: float) -> float:
    return float(np.percentile(np.asarray(resp_us), q)) if resp_us else 0.0


def _hist_add(hist: np.ndarray, ticks) -> np.ndarray:
    """Fold a batch of response ticks into the engine's log-bucket
    histogram (same buckets as the commit-latency histogram, so both
    percentile paths share ``_pct_from_hist``)."""
    b = np.minimum(np.searchsorted(HIST_THRESHOLDS, ticks, side="right"),
                   N_HIST - 1)
    return hist + np.bincount(b, minlength=N_HIST)


class _Lane:
    """Host-side open-system bookkeeping for one cell (device holds the
    pool state; this mirror holds the queue, credits, and arrival times)."""

    def __init__(self, cell: ServeCell, dev: torch.device,
                 keep_responses: bool = False):
        self.cell = cell
        self.dev = dev
        self.arr = cell.schedule.times
        self.ptr = 0                            # next unadmitted arrival
        self.queue: deque[int] = deque()        # admitted, undispatched
        self.assigned = [deque() for _ in range(cell.n_threads)]
        self.caps = np.zeros(cell.n_threads, dtype=np.int64)
        self.txn = np.zeros(cell.n_threads, dtype=np.int64)
        self.arrived = self.rejected = self.shed = 0
        self.dispatched = self.completed = self.sla_miss = 0
        # whole-run response accounting is histogram-based (log
        # buckets + exact sum/max) so memory is O(N_HIST), not
        # O(completions); the raw list is opt-in for parity tests
        self.resp_hist = np.zeros(N_HIST, dtype=np.int64)
        self.resp_sum_ticks = 0
        self.resp_max_ticks = 0
        self.resp_us: list[float] | None = [] if keep_responses else None
        self.history: list[SegmentRecord] = []
        self.records: list[ServingRecord] = []
        self.g_prev = None                      # host Globals snapshot
        self.all_ordered = True                 # switch-safety mirror

    def admit(self, boundary: int) -> tuple[int, int, int]:
        """Admit every not-yet-seen arrival with time <= boundary."""
        c = self.cell
        n_arr = n_rej = n_shed = 0
        while self.ptr < self.arr.size and self.arr[self.ptr] <= boundary:
            t = int(self.arr[self.ptr])
            self.ptr += 1
            n_arr += 1
            if c.admission == "wait" or len(self.queue) < c.queue_cap:
                self.queue.append(t)
            elif c.admission == "reject":
                n_rej += 1
            else:                               # shed: drop the oldest
                self.queue.popleft()
                self.queue.append(t)
                n_shed += 1
        self.arrived += n_arr
        self.rejected += n_rej
        self.shed += n_shed
        return n_arr, n_rej, n_shed

    def dispatch(self) -> None:
        """Queue -> per-slot credits, round-robin least-outstanding first.

        Each round tops up every slot below ``max_outstanding`` by one
        credit in (outstanding, tid) order, so the load spreads evenly
        and deterministically; stops when the queue drains or every slot
        is at its cap.
        """
        c = self.cell
        out = self.caps - self.txn
        while self.queue:
            order = sorted(range(c.n_threads), key=lambda t: (out[t], t))
            moved = False
            for t in order:
                if not self.queue:
                    break
                if out[t] >= c.max_outstanding:
                    continue
                self.assigned[t].append(self.queue.popleft())
                self.caps[t] += 1
                out[t] += 1
                self.dispatched += 1
                moved = True
            if not moved:
                break

    def retire(self, txn_now: np.ndarray, t1: int) -> tuple[int, list]:
        """Match per-thread txn deltas to assigned arrivals, FIFO."""
        c = self.cell
        window: list[float] = []
        rts: list[int] = []
        for t in range(c.n_threads):
            d = int(txn_now[t]) - int(self.txn[t])
            assert 0 <= d <= len(self.assigned[t]), (
                f"cell {c.name!r} slot {t}: {d} completions vs "
                f"{len(self.assigned[t])} assigned — credit ledger broken")
            for _ in range(d):
                rt = t1 - self.assigned[t].popleft()       # ticks, exact
                rts.append(rt)
                resp = rt / 10.0                           # -> us
                window.append(resp)
                if self.resp_us is not None:
                    self.resp_us.append(resp)
                if c.sla_us > 0 and resp > c.sla_us:
                    self.sla_miss += 1
        if rts:
            self.resp_hist = _hist_add(self.resp_hist, rts)
            self.resp_sum_ticks += sum(rts)
            self.resp_max_ticks = max(self.resp_max_ticks, max(rts))
        self.txn = txn_now.astype(np.int64)
        self.completed += len(window)
        return len(window), window

    @property
    def in_flight(self) -> int:
        return int((self.caps - self.txn).sum())

    def check_conservation(self, where: str) -> None:
        """Every request is exactly one of: rejected, shed, queued,
        in flight, completed — asserted at every boundary, not just at
        the end (the property tests re-check this from the records)."""
        lhs = self.arrived
        rhs = (self.rejected + self.shed + len(self.queue)
               + self.dispatched)
        assert lhs == rhs, (
            f"cell {self.cell.name!r} @ {where}: arrived {lhs} != "
            f"rejected {self.rejected} + shed {self.shed} + queued "
            f"{len(self.queue)} + dispatched {self.dispatched}")
        assert self.dispatched == self.completed + self.in_flight, (
            f"cell {self.cell.name!r} @ {where}: dispatched "
            f"{self.dispatched} != completed {self.completed} + in-flight "
            f"{self.in_flight}")

    def cap_vector(self, pad_t: int) -> torch.Tensor:
        """The segment's per-thread quota, an i32 tensor on the lanes'
        device (the engine reads a pack's device from it; padded slots get
        0 — they are masked HALT by ``n_active`` anyway)."""
        v = np.zeros(pad_t, dtype=np.int64)
        v[:self.cell.n_threads] = self.caps
        assert v.max() < 2**30, "credit counter would overflow the i32 INF"
        return torch.from_numpy(v.astype(np.int32)).to(self.dev)

    def revive_row(self, pad_t: int) -> np.ndarray:
        """Slots holding unserved credits must be running. Outstanding
        == 0 implies the engine HALTed the slot (quota check rides the
        commit iteration), so flipping HALT->START exactly on
        ``caps > txn`` wakes every refilled slot and nothing else."""
        row = np.zeros(pad_t, dtype=bool)
        row[:self.cell.n_threads] = self.caps > self.txn
        return row


def _revive(packed, width: int, rows: np.ndarray):
    """Flip HALT->START on the packed pool state (a device-side select; no
    phase readback). ``rows`` is (width, T) bool; only genuinely HALTed
    slots change, so a wrong host mirror could never corrupt a live one.
    The state is rebuilt, never changed in place."""
    ph = packed.th.phase
    m = torch.from_numpy(rows[0] if width == 1 else rows).to(ph.device)
    new = torch.where(m & (ph == _engine.HALT),
                      torch.tensor(_engine.START, dtype=I32,
                                   device=ph.device), ph)
    return packed._replace(th=packed.th._replace(phase=new))


def serve(cells: Iterable[ServeCell], *, seg_ticks: int,
          chunk_size: int | None = None, return_states: bool = False,
          keep_responses: bool = False, metrics_registry=None,
          verbose: bool = False, device=None) -> ServeResults:
    """Serve every cell's arrival schedule over its horizon on ``device``
    (default: the CUDA card).

    ``seg_ticks`` sets the boundary grid (admission/dispatch/observation
    points): boundaries at ``seg_ticks, 2*seg_ticks, ..., horizon``. All
    cells must share one horizon — lanes advance through shared
    boundaries so bucket-mates ride one pack. Smaller segments mean finer
    admission latency and response-time resolution but more host
    round-trips; DESIGN.md §10 discusses the quantization.

    Returns :class:`ServeResults`: SweepResults-compatible (metrics /
    segments / store) plus ``serving[name]`` summaries. Whole-run
    percentiles (p50/p99/p999) come from the device-side log-bucket
    response histogram (memory O(N_HIST) regardless of horizon);
    ``keep_responses=True`` additionally keeps every raw response in
    ``ServeResults.responses[name]`` for parity checks.

    ``metrics_registry`` (a :class:`repro_torch.serving.metrics.
    ServingMetrics`) is fed every boundary record as it is produced — the
    live-scrape path: render/dump/serve_http it concurrently from another
    thread.
    """
    cells = list(cells)
    assert cells and seg_ticks >= 1
    names = [c.name for c in cells]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate serve cell names: {dup[:5]}")
    horizons = {c.schedule.horizon for c in cells}
    if len(horizons) != 1:
        raise ValueError(f"serve cells must share one horizon, got "
                         f"{sorted(horizons)}")
    horizon = horizons.pop()
    dev = resolve(device)
    chunk_size = chunk_size or _auto_chunk(dev)

    bounds = list(range(seg_ticks, horizon, seg_ticks)) + [horizon]

    buckets: dict[tuple, list[int]] = {}
    for i, c in enumerate(cells):
        w = c.workload
        pad_t = _pow2ceil(c.n_threads, MIN_T_BUCKET)
        buckets.setdefault((w.kind, w.n_rows, pad_t, w.txn_len),
                           []).append(i)

    metrics, wall_us, segments = {}, {}, {}
    serving: dict[str, ServingResult] = {}
    states_out: dict[str, object] = {}
    responses_out: dict[str, list] = {}
    infos: list[BucketInfo] = []
    t_start = time.perf_counter()

    for key, idxs in buckets.items():
        kind, n_rows, pad_t, pad_l = key
        bcells = [cells[i] for i in idxs]
        G = len(bcells)
        t_bucket = time.perf_counter()

        lanes = [_Lane(c, dev, keep_responses) for c in bcells]
        for c in bcells:
            if c.policy is not None:
                c.policy.reset(c.n_threads)
        presets = [c.policy.decide(0, []) if c.policy else c.preset
                   for c in bcells]

        # boundary 0: admit the opening arrivals, dispatch the first
        # credits, then build the initial device states (phase START is
        # correct everywhere: credit-less slots self-HALT on their first
        # quota check, credited slots run)
        stat = None
        states = []
        prologue = []           # t=0 admissions, folded into record 0
        for ln, c, p in zip(lanes, bcells, presets):
            prologue.append(ln.admit(0))
            ln.dispatch()
            ln.check_conservation("t=0")
            st, dp0 = _engine.split_config(_cell_config(c, p, seg_ticks),
                                           pad_threads=pad_t,
                                           pad_len=pad_l, device=dev)
            assert stat is None or st == stat
            stat = st
            s0 = _engine.init_state_dyn(st, dp0)
            states.append(s0)
            ln.g_prev = to_host(s0.g)
            ln.all_ordered = bool(preset_params(p).ordered_acquire)

        groups = [list(range(lo, min(lo + chunk_size, G)))
                  for lo in range(0, G, max(chunk_size, 1))]
        gpacked: list = [None] * len(groups)
        gwidth: list = [0] * len(groups)
        lane_iters = 0

        for k, until in enumerate(bounds):
            if k:
                presets = [c.policy.decide(k, ln.history)
                           if c.policy else c.preset
                           for c, ln in zip(bcells, lanes)]
            dps = []
            for ln, c, p in zip(lanes, bcells, presets):
                if k and not switch_safe(p) and not ln.all_ordered:
                    # same rule as run_governed; serving workloads are
                    # static so the rank-rotation clause can't trip
                    raise ValueError(
                        f"serve cell {c.name!r}: policy {c.label()!r} "
                        f"runs resolver-free preset {p!r} at boundary "
                        f"{k} after an unordered-preset segment; "
                        "inherited out-of-order locks can cycle "
                        "unresolvably — use 'brook_guard' "
                        "(DESIGN.md §9.2)")
                ln.all_ordered &= bool(preset_params(p).ordered_acquire)
                dp = _engine.split_config(_cell_config(c, p, seg_ticks),
                                          pad_threads=pad_t,
                                          pad_len=pad_l, device=dev)[1]
                dps.append(dp._replace(txn_cap=ln.cap_vector(pad_t)))

            for gi, grp in enumerate(groups):
                packed = gpacked[gi]
                if packed is not None:
                    rows = np.stack([lanes[j].revive_row(pad_t)
                                     for j in grp]
                                    + [np.zeros(pad_t, dtype=bool)]
                                    * (gwidth[gi] - len(grp)))
                    packed = _revive(packed, gwidth[gi], rows)
                gpacked[gi], snaps, w = run_packed_segment(
                    stat, [dps[j] for j in grp],
                    [states[j] for j in grp], [until] * len(grp),
                    packed=packed)
                gwidth[gi] = w
                g_host, txn_host, snap_host = to_host(
                    (gpacked[gi].g, gpacked[gi].th.txn, snaps))
                txn_host = txn_host.numpy()
                d_iters = 0
                for lane_i, j in enumerate(grp):
                    ln, c, p = lanes[j], bcells[j], presets[j]
                    if w == 1:
                        g_now, txn_now, snap = g_host, txn_host, snap_host
                    else:
                        g_now = take_lane(g_host, lane_i)
                        txn_now = txn_host[lane_i]
                        snap = take_lane(snap_host, lane_i)
                    d_iters = max(d_iters,
                                  int(g_now.iters) - int(ln.g_prev.iters))
                    t0, t1 = int(ln.g_prev.now), int(g_now.now)
                    n_done, window = ln.retire(
                        txn_now[:c.n_threads], t1)
                    n_arr, n_rej, n_shed = ln.admit(until)
                    if k == 0:      # attribute the t=0 prologue here so
                                    # the records sum to the lane totals
                        p_arr, p_rej, p_shed = prologue[j]
                        n_arr += p_arr
                        n_rej += p_rej
                        n_shed += p_shed
                    ln.dispatch()
                    ln.check_conservation(f"t={until}")
                    rec = segment_record(k, p, c.n_threads, ln.g_prev,
                                         g_now, snap)
                    ln.history.append(rec)
                    ln.records.append(ServingRecord(
                        index=k, t0=t0, t1=t1, preset=p, metrics=rec.metrics,
                        arrived=n_arr, rejected=n_rej, shed=n_shed,
                        completed=n_done, qlen=len(ln.queue),
                        in_flight=ln.in_flight,
                        p50_us=_pctl(window, 50.0),
                        p99_us=_pctl(window, 99.0),
                        p999_us=_pctl(window, 99.9),
                        sla_miss=sum(1 for u in window
                                     if c.sla_us > 0 and u > c.sla_us),
                        max_qlen=rec.max_qlen, n_waiting=rec.n_waiting))
                    if metrics_registry is not None:
                        metrics_registry.observe(c.name, ln.records[-1])
                    ln.g_prev = g_now
                lane_iters += w * d_iters

        if return_states:
            for gi, grp in enumerate(groups):
                for lane_i, j in enumerate(grp):
                    states_out[bcells[j].name] = (
                        gpacked[gi] if gwidth[gi] == 1
                        else take_lane(gpacked[gi], lane_i))

        wall_b = time.perf_counter() - t_bucket
        for ln, c in zip(lanes, bcells):
            eng = extract_globals(c.label(), c.n_threads, ln.g_prev)
            metrics[c.name] = eng
            wall_us[c.name] = wall_b * 1e6 / G
            segments[c.name] = [rec.as_json() for rec in ln.records]
            sim_s = horizon / TICKS_PER_SEC
            # whole-run percentiles from the histogram: bucket
            # midpoints, clamped to the exact observed max so
            # p50 <= p99 <= p999 <= max holds regardless of bucket edges
            hist_np = ln.resp_hist
            assert int(hist_np.sum()) == ln.completed, (
                f"cell {c.name!r}: response histogram holds "
                f"{int(hist_np.sum())} responses, lane completed "
                f"{ln.completed}")
            max_us = ln.resp_max_ticks / 10.0
            pct = lambda q: min(_pct_from_hist(hist_np, q), max_us)
            if keep_responses:
                responses_out[c.name] = list(ln.resp_us)
            serving[c.name] = ServingResult(
                name=c.name, label=c.label(),
                schedule=c.schedule.meta(),
                offered_tps=c.schedule.offered_tps,
                completed_tps=ln.completed / sim_s,
                goodput_tps=eng.tps,
                arrived=ln.arrived, rejected=ln.rejected, shed=ln.shed,
                dispatched=ln.dispatched, completed=ln.completed,
                qlen_end=len(ln.queue), in_flight_end=ln.in_flight,
                mean_resp_us=(ln.resp_sum_ticks / ln.completed / 10.0
                              if ln.completed else 0.0),
                p50_us=pct(0.50),
                p99_us=pct(0.99),
                p999_us=pct(0.999),
                max_us=max_us,
                sla_us=c.sla_us, sla_miss=ln.sla_miss,
                sla_miss_frac=(ln.sla_miss / ln.completed
                               if c.sla_us > 0 and ln.completed else 0.0),
                utilization=eng.cpu_util, engine=eng)
        infos.append(BucketInfo(
            family="serving", kind=kind, n_rows=n_rows, pad_threads=pad_t,
            pad_len=pad_l, n_points=G, n_chunks=len(groups),
            wall_s=wall_b, lane_iters=lane_iters))
        if verbose:
            print(f"# serving bucket {kind}/R{n_rows}: {G} cell(s), "
                  f"T<={pad_t}, {len(bounds)} boundaries, {wall_b:.1f}s")

    points = [SweepPoint(
        protocol=c.label(), workload=c.workload, n_threads=c.n_threads,
        horizon=c.schedule.horizon, p_abort=c.p_abort, costs=c.costs,
        name=c.name, tag=c.schedule.name) for c in cells]
    return ServeResults(
        points=points, metrics=metrics, wall_us=wall_us, buckets=infos,
        n_compiles=0, wall_s=time.perf_counter() - t_start,
        segments=segments, serving=serving, states=states_out,
        responses=responses_out)
