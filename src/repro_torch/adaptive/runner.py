"""Governed execution: (policy × drift-scenario) cells on the sweep substrate.

The port of ``repro.adaptive.runner``. A :class:`GovernorCell` pairs a
:class:`~repro_torch.adaptive.governor.Policy` with a
:class:`~repro_torch.core.lock.workload.DriftSchedule`. ``run_governed``
executes every cell as a sequence of resumable engine segments: before each
segment the cell's policy reads the telemetry history and picks a preset,
the drift schedule supplies the segment's workload, and the engine is
re-entered with the new parameter values.

Cells sharing a shape key (kind, padded T, L, R) form one bucket. Its lanes
run in groups of at most ``chunk_size``: a group of one through
``engine._run_seg_dyn``, a wider group stacked and stepped together as one
pack (``engine._run_seg_batch``, via ``sweep.runner.run_packed_segment``),
segment by segment — policies stay host-side Python between segments
either way.

What differs from the reference:

* **Device.** ``device=None`` is the CUDA card (``repro_torch.device``);
  the default lane width is the sweep's (:data:`CUDA_CHUNK` lanes on the
  card, 1 on the CPU).
* **Host reads.** At each boundary a group's ``Globals`` and snapshots come
  to the host together (``sweep.runner.to_host``) and are sliced per lane
  there, where the reference reads them with ``jax.device_get``.
* **Compile count.** The port compiles nothing per shape (eager torch), so
  ``n_compiles`` is 0, as in the port's sweep.
* **Lane-iterations.** Each bucket's ``lane_iters`` counts, per group and
  segment, the pack's width times its largest per-lane iteration delta:
  what the pack paid in lockstep (the reference leaves it 0 here).

Results come back as a plain :class:`~repro_torch.sweep.runner.SweepResults`
whose ``segments`` field carries the per-segment time series, so the JSON
store (schema ``repro.sweep/v4``) and ``summarize`` work unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import torch

from ..core.lock import engine as _engine
from ..core.lock.costs import CostModel
from ..core.lock.engine import EngineConfig, take_lane
from ..core.lock.metrics import extract_globals, extract_segment
from ..core.lock.workload import DriftSchedule
from ..device import resolve
from ..sweep.grid import SweepPoint
from ..sweep.runner import (BucketInfo, SweepResults, MIN_T_BUCKET,
                            _auto_chunk, _pow2ceil, run_packed_segment,
                            to_host)

from .governor import Policy, SegmentRecord, preset_params, switch_safe


@dataclasses.dataclass(frozen=True)
class GovernorCell:
    """One governed run: a policy steering one drifting workload."""
    name: str
    policy: Policy
    drift: DriftSchedule
    n_threads: int
    costs: CostModel = CostModel()
    p_abort: float = 0.0
    attrib: bool = False            # per-record contention accumulator

    def label(self) -> str:
        return self.policy.name


def _cell_config(cell: GovernorCell, preset: str, seg: int,
                 horizon: int, n_segments: int | None = None
                 ) -> EngineConfig:
    return EngineConfig(
        protocol=preset_params(preset, horizon=horizon,
                               n_segments=n_segments),
        costs=cell.costs,
        workload=cell.drift.spec(seg), n_threads=cell.n_threads,
        horizon=horizon, p_abort=cell.p_abort, attrib=cell.attrib)


def segment_record(index: int, preset: str, n_threads: int, g0, g1,
                   snap) -> SegmentRecord:
    """A :class:`SegmentRecord` from host copies of the boundary Globals
    ``g0``/``g1`` and the snapshot at ``g1``."""
    return SegmentRecord(
        index=index, t0=int(g0.now), t1=int(g1.now), preset=preset,
        metrics=extract_segment(preset, n_threads, g0, g1),
        max_qlen=int(snap.max_qlen), n_hot=int(snap.n_hot),
        n_live=int(snap.n_live), n_waiting=int(snap.n_waiting),
        wait_hist=tuple(snap.wait_hist.tolist()),
        occ_hist=tuple(snap.occ_hist.tolist()))


def run_governed(cells: Iterable[GovernorCell], *, horizon: int,
                 n_segments: int, chunk_size: int | None = None,
                 verbose: bool = False, device=None) -> SweepResults:
    """Run every cell for ``n_segments`` governed segments over ``horizon``
    on ``device`` (default: the CUDA card).

    Segment boundaries are ``horizon * (k+1) // n_segments``; a busy cell
    pauses at its first event past the boundary, a stalled one exactly at
    it (``engine._make_step``), so a cell whose policy never switches and
    whose drift is stationary equals a single-shot ``simulate()`` of the
    same config, ``iters`` aside — segmentation is pause/resume, not
    restart. ``chunk_size`` bounds how many lanes share one pack (1 =
    sequential single-lane runs); the default is the sweep's
    (:func:`~repro_torch.sweep.runner._auto_chunk`).
    """
    cells = list(cells)
    names = [c.name for c in cells]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate governor cell names: {dup[:5]}")
    for c in cells:
        assert c.drift.n_segments >= 1
    dev = resolve(device)
    chunk_size = chunk_size or _auto_chunk(dev)

    # bucket by shape key, padding threads to the pow2 cap like the sweep
    buckets: dict[tuple, list[int]] = {}
    for i, c in enumerate(cells):
        w = c.drift.base
        pad_t = _pow2ceil(c.n_threads, MIN_T_BUCKET)
        buckets.setdefault((w.kind, w.n_rows, pad_t, w.txn_len),
                           []).append(i)

    metrics, wall_us, segments = {}, {}, {}
    infos: list[BucketInfo] = []
    t_start = time.perf_counter()

    for key, idxs in buckets.items():
        kind, n_rows, pad_t, pad_l = key
        bcells = [cells[i] for i in idxs]
        G = len(bcells)
        t_bucket = time.perf_counter()

        for c in bcells:
            c.policy.reset(c.n_threads)
        history: list[list[SegmentRecord]] = [[] for _ in bcells]

        # initial states + host-side Globals snapshots (all-zero counters)
        stat = None
        states, g_prev, preset0 = [], [], []
        for c in bcells:
            p0 = c.policy.decide(0, [])
            preset0.append(p0)
            st, dp0 = _engine.split_config(
                _cell_config(c, p0, 0, horizon, n_segments),
                pad_threads=pad_t, pad_len=pad_l, device=dev)
            assert stat is None or st == stat
            stat = st
            s0 = _engine.init_state_dyn(st, dp0)
            states.append(s0)
            g_prev.append(to_host(s0.g))

        # lane groups: at most chunk_size cells share one pack (groups of 1
        # run unstacked); passing each group's packed state back keeps the
        # stack on the device across segments, so a segment costs one host
        # transfer per group, never per-lane gathers or re-stacks
        groups = [list(range(lo, min(lo + chunk_size, G)))
                  for lo in range(0, G, max(chunk_size, 1))]
        gpacked: list = [None] * len(groups)
        lane_iters = 0

        # Mid-run safety for resolver-free presets (pure brook2pl /
        # brook_hold: no detection walk, no wait timeout — DESIGN §9.2).
        # Such a preset is deadlock-free only while EVERY in-flight
        # transaction follows its current chop order, which holds iff
        # (a) every preceding segment ran an ordered_acquire preset
        # (a single unordered segment can leave cycle-capable holders
        # that outlive many boundaries — a one-segment brook_guard hop
        # does NOT launder them, its timeout may not have fired yet) and
        # (b) the chop rank table has been stable since segment 0
        # (drift that rotates acq_rank, e.g. hot_migration, makes new
        # txns disagree with in-flight ones about the order). Violations
        # fail loudly here.
        all_ordered = [True] * G
        rank_stable = [True] * G
        prev_rank: list = [None] * G

        for k in range(n_segments):
            until = horizon * (k + 1) // n_segments
            presets = ([c.policy.decide(k, h)
                        for c, h in zip(bcells, history)]
                       if k else preset0)
            dps = [_engine.split_config(
                _cell_config(c, p, k, horizon, n_segments),
                pad_threads=pad_t, pad_len=pad_l, device=dev)[1]
                for c, p in zip(bcells, presets)]
            ranks = [dp.wl.acq_rank for dp in dps]
            for j, (c, p) in enumerate(zip(bcells, presets)):
                if k:
                    rank_stable[j] &= torch.equal(prev_rank[j], ranks[j])
                if k and not switch_safe(p):
                    if not all_ordered[j]:
                        raise ValueError(
                            f"cell {c.name!r}: policy {c.policy.name!r} "
                            f"runs resolver-free preset {p!r} at segment "
                            f"{k} after an unordered-preset segment; "
                            "inherited out-of-order locks can cycle "
                            "unresolvably — use 'brook_guard' instead "
                            "(DESIGN.md §9.2)")
                    if not rank_stable[j]:
                        raise ValueError(
                            f"cell {c.name!r}: drift "
                            f"{c.drift.name!r} rotated the chop rank "
                            f"table by segment {k} while resolver-free "
                            f"preset {p!r} is active; in-flight and new "
                            "transactions would disagree about the lock "
                            "order — use 'brook_guard' under rank-"
                            "rotating drift (DESIGN.md §9.2)")
                all_ordered[j] &= bool(preset_params(p).ordered_acquire)
            prev_rank = ranks
            outs: list = [None] * G
            for gi, grp in enumerate(groups):
                gpacked[gi], snaps, w = run_packed_segment(
                    stat, [dps[j] for j in grp],
                    [states[j] for j in grp], [until] * len(grp),
                    packed=gpacked[gi])
                g_host, snap_host = to_host((gpacked[gi].g, snaps))
                if w == 1:
                    outs[grp[0]] = (g_host, snap_host)
                else:
                    for lane, j in enumerate(grp):
                        outs[j] = (take_lane(g_host, lane),
                                   take_lane(snap_host, lane))
                lane_iters += w * max(
                    int(outs[j][0].iters) - int(g_prev[j].iters)
                    for j in grp)
            for j, (c, p) in enumerate(zip(bcells, presets)):
                g_now, snap = outs[j]
                history[j].append(segment_record(k, p, c.n_threads,
                                                 g_prev[j], g_now, snap))
                g_prev[j] = g_now

        wall_b = time.perf_counter() - t_bucket
        for j, c in enumerate(bcells):
            metrics[c.name] = extract_globals(c.label(), c.n_threads,
                                              g_prev[j])
            wall_us[c.name] = wall_b * 1e6 / G
            segments[c.name] = [r.as_json() for r in history[j]]
        infos.append(BucketInfo(
            family="governed", kind=kind, n_rows=n_rows, pad_threads=pad_t,
            pad_len=pad_l, n_points=G, n_chunks=len(groups), wall_s=wall_b,
            lane_iters=lane_iters))
        if verbose:
            print(f"# governed bucket {kind}/R{n_rows}: {G} cell(s), "
                  f"T<={pad_t}, {n_segments} segment(s), {wall_b:.1f}s")

    points = [SweepPoint(
        protocol=c.label(), workload=c.drift.base, n_threads=c.n_threads,
        horizon=horizon, p_abort=c.p_abort, costs=c.costs,
        name=c.name, tag=c.drift.name) for c in cells]
    return SweepResults(
        points=points, metrics=metrics, wall_us=wall_us, buckets=infos,
        n_compiles=0, wall_s=time.perf_counter() - t_start,
        segments=segments)


def preset_timeline(res: SweepResults, name: str) -> list[str]:
    """The per-segment preset sequence a cell's policy chose."""
    return [seg["preset"] for seg in res.segments[name]]
