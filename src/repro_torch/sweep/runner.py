"""Batched sweep runner: one pack of lanes per shape bucket, on the card.

The port of ``repro.sweep.runner``. Points are bucketed by their shape key
— ``(family, kind, n_rows)`` where family is the tick engine or Aria — then
padded to the bucket's thread count and txn length, stacked into
parameters with a leading lane axis (``engine.stack_lanes``) and run as
one pack (``engine._run_batch``): one sequence of torch calls steps every
lane of the pack, which is what a lane axis buys on a host-dispatch-bound
card.

Within a bucket, packed execution (``chunk_size > 1``) defaults to the
**lockstep compaction scheduler**: lanes run in iteration-budget slices
(``max_iters`` capped at ``iters + slice``); between slices finished lanes
retire into results, survivors are repacked into a smaller pow2-width pack
(the tail pad replicates the last lane and is never read back), and freed
slots are topped up from the not-yet-started queue. ``compact=False``
restores sort-then-cut chunking (:func:`_make_chunks`), which is also the
path taken at ``chunk_size=1``.

Per-lane results equal a per-config ``simulate()`` run bit for bit on both
paths, ``iters`` included: a pack freezes finished lanes, padding is
masked out of the engine, and pausing a lane at an iteration budget and
resuming it replays the identical step sequence.

What the port has in place of JAX's machinery:

* **Compile counts.** The reference counts its jit cache. The port
  compiles nothing per shape (eager torch, no CUDA-graph captures), so
  ``SweepResults.n_compiles`` is 0; the key stays so that store documents
  of the two packages stay interchangeable.
* **Lane sharding.** The reference shards each pack's lane axis over a
  device mesh (``_shard_lanes``) and is a no-op on one device. With
  ``shard=True`` and several devices (every visible card, or ``devices=[...]``)
  the port splits each bucket's lanes by the same rule (:func:`_shard_lanes`:
  the lane axis padded to a multiple of the device count by replicating the
  last lane, device ``i`` holding the ``i``-th contiguous block; a pad slot
  is never run or read) and runs each device's share in a spawned worker
  process of its own (:func:`_run_sharded`), each with :func:`_auto_chunk`'s
  width. Processes, not threads: the engine step is host-dispatch bound
  (~800 torch calls an iteration), and threads would serialise on the GIL.
  A lane's result does not depend on its packmates, so the split leaves
  every result bit-identical. The segmented runners
  (:func:`run_packed_segment`) keep one device.
* **Lane width.** :func:`_auto_chunk` returns 1 on the CPU (the
  reference's single-device choice) and :data:`CUDA_CHUNK` on the card,
  set from ``chip_smoke.py``'s ``batch_width`` measurement (see the
  constant).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import time
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, Sequence

import torch

from ..core.lock import engine as _engine
from ..core.lock import aria as _aria
from ..core.lock.costs import PROTOCOLS, protocol_params
from ..core.lock.engine import EngineConfig, stack_lanes, take_lane
from ..core.lock.metrics import (SimResult, TICKS_PER_SEC, bench_row,
                                 extract_globals)
from ..core.lock.aria import AriaConfig, extract_aria
from ..device import resolve

from .grid import SweepPoint

MIN_T_BUCKET = 64       # small configs share one padded shape
DEFAULT_SLICES = 8      # iteration-budget slices per nominal lane run
# Lanes per pack on a CUDA device. The engine step is host-dispatch bound
# (~800 torch calls an iteration), so a pack of G lanes costs about one
# lane's calls until the device work of G lanes outgrows the dispatch.
# chip_smoke.py's batch_width phase (hotspot_update, T=1024, R=1,000,000,
# txn_len 8, 200 iterations a lane; NVIDIA H100 80GB HBM3, 700 W) measured
# 12.8, 10.0, 12.7, 11.5 and 12.8 ms per packed iteration at G = 1, 2, 4, 8
# and 16: flat, so a lane-iteration fell from 12.8 to 0.80 ms, with 3.5 GiB
# of device memory at G = 16. 16 is the widest width measured.
CUDA_CHUNK = 16

KNOWN_PROTOCOLS = PROTOCOLS + ("aria",)


def _pow2ceil(n: int, floor: int = 1) -> int:
    v = max(int(n), floor)
    return 1 << (v - 1).bit_length()


_EST_WARNED: set[str] = set()


def _est_iters(p: SweepPoint) -> float:
    """Crude engine-iteration estimate for lockstep-aware scheduling.

    A pack steps every lane until the slowest finishes, so similar-
    iteration lanes should run together. Iterations track commits (~2
    events per commit), so the analytic chain model (``ref_engine``) is a
    good relative predictor; only the ordering and rough scale matter.
    """
    c = p.costs
    if p.protocol == "aria":
        return p.horizon / max(_aria.batch_ticks(p.workload, c), 1)
    try:
        from ..core.lock.ref_engine import predicted_tps
        chain = TICKS_PER_SEC / predicted_tps(
            p.protocol, p.n_threads, c,
            params=protocol_params(p.protocol, **p.over()))
    except (ValueError, ZeroDivisionError) as e:
        # the analytic model not covering a (protocol, knob) combination
        # is expected; anything else is a real bug and propagates
        if p.protocol not in _EST_WARNED:
            _EST_WARNED.add(p.protocol)
            warnings.warn(
                f"_est_iters: analytic model failed for {p.protocol!r} "
                f"({e}); falling back to the cost-chain estimate "
                f"(scheduling order may degrade)", RuntimeWarning,
                stacklevel=2)
        chain = p.workload.txn_len * c.op_exec + c.commit_base + c.sync_lat
    return p.horizon / max(chain, 1)


def _make_chunks(bpts: list[SweepPoint], chunk_size: int
                 ) -> list[list[SweepPoint]]:
    """Sort by estimated iterations (desc), then cut fixed-size chunks."""
    spts = sorted(bpts, key=_est_iters, reverse=True)
    return [spts[lo:lo + chunk_size]
            for lo in range(0, len(spts), chunk_size)]


def _auto_chunk(device: torch.device) -> int:
    """Lanes per pack when the caller doesn't say: :data:`CUDA_CHUNK` on a
    CUDA device, 1 (sequential single-lane packs) on the CPU, where a
    lane's device work is not overlapped with anything."""
    return CUDA_CHUNK if device.type == "cuda" else 1


@dataclasses.dataclass(frozen=True)
class BucketInfo:
    family: str             # "engine" | "aria"
    kind: str
    n_rows: int
    pad_threads: int
    pad_len: int
    n_points: int
    n_chunks: int           # packed calls (chunks, or compaction slices)
    wall_s: float
    # --- compaction accounting (zero / empty on the sort-then-cut path) ---
    compacted: bool = False
    n_repacks: int = 0      # calls after which survivors were re-gathered
    lane_iters: int = 0     # sum over calls of width x max lane-iterations
    repack_log: tuple = ()  # per-call (n_live, width, max_delta_iters)


@dataclasses.dataclass
class SweepResults:
    """Ordered results of one sweep run.

    ``segments`` is the optional per-point time series that governed runs
    attach; plain sweeps leave it empty. ``n_compiles`` is 0 in the port
    (see the module docstring).
    """
    points: list[SweepPoint]
    metrics: dict[str, SimResult]       # name -> extracted metrics
    wall_us: dict[str, float]           # name -> amortized wall per point
    buckets: list[BucketInfo]
    n_compiles: int
    wall_s: float
    segments: dict[str, list] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> SimResult:
        return self.metrics[name]

    def names(self) -> list[str]:
        return [p.name for p in self.points]

    @property
    def lane_iters(self) -> int:
        """Total packed lane-iterations paid (width x slowest-lane iters,
        summed over calls) — the sweep's modeled lockstep cost."""
        return sum(b.lane_iters for b in self.buckets)

    @property
    def n_repacks(self) -> int:
        return sum(b.n_repacks for b in self.buckets)


def _bucket_key(p: SweepPoint, thread_bucket) -> tuple:
    """Shape bucket for a point.

    ``thread_bucket="pow2"`` (default) sub-buckets by power-of-2 thread
    count (floor 64) and pads to that cap, so lanes never carry more than
    2x thread padding; txn_len stays exact. ``thread_bucket="max"`` forces
    one bucket per (family, kind, R) padded to the grid max.
    """
    family = "aria" if p.protocol == "aria" else "engine"
    base = (family, p.workload.kind, p.workload.n_rows)
    if thread_bucket == "max":
        return base
    if thread_bucket == "pow2":
        return base + (_pow2ceil(p.n_threads, MIN_T_BUCKET),
                       p.workload.txn_len)
    raise ValueError(f"thread_bucket={thread_bucket!r}")


def _engine_config(p: SweepPoint) -> EngineConfig:
    return EngineConfig(
        protocol=protocol_params(p.protocol, **p.over()),
        costs=p.costs, workload=p.workload, n_threads=p.n_threads,
        horizon=p.horizon, p_abort=p.p_abort, drain=p.drain)


def _check_aria_point(p: SweepPoint) -> None:
    """Aria has no injected aborts, drain mode, or protocol knobs; reject
    rather than silently running defaults under a name that claims them."""
    unsupported = []
    if p.p_abort:
        unsupported.append(f"p_abort={p.p_abort}")
    if p.drain:
        unsupported.append("drain=True")
    if p.proto_over:
        unsupported.append(f"proto_over={dict(p.proto_over)}")
    if unsupported:
        raise ValueError(
            f"sweep point {p.name!r}: aria does not support "
            + ", ".join(unsupported))


def _pack(trees: Sequence, g: int):
    """Stack n lane trees to width ``g``, replicating the last lane into
    the tail pad (never read back)."""
    trees = list(trees)
    return stack_lanes(trees + [trees[-1]] * (g - len(trees)))


def run_packed_segment(stat, dps, states, untils, *, shard: bool = False,
                       packed=None):
    """Advance n engine lanes one segment as a single pack.

    Lanes are stacked to a pow2 width (tail replicated via :func:`_pack`)
    and stepped through ``engine._run_seg_batch``; a single lane runs
    ``engine._run_seg_dyn``, unstacked. ``shard`` is accepted for the
    reference's signature (which places lanes over its host mesh) and does
    nothing on any number of cards: the port splits lanes over cards with
    one worker process a device (:func:`_run_sharded`), and such a process
    cannot keep a pack resident across segments, which is what ``packed``
    is for.

    Returns ``(packed_states, packed_snaps, width)`` — lane ``i`` of each
    packed output is input lane ``i`` (``engine.take_lane``); ``width ==
    1`` returns the bare state/snapshot. Pass ``packed_states`` back as
    ``packed`` on the next segment of the SAME lane set to keep the stack
    resident (``states`` is only read when ``packed`` is None).
    """
    n = len(dps)
    if n == 1:
        s0 = packed if packed is not None else states[0]
        s, snap = _engine._run_seg_dyn(stat, dps[0], s0, int(untils[0]))
        return s, snap, 1
    if packed is not None:
        s_s = packed
        g = s_s.g.now.shape[0]
    else:
        g = _pow2ceil(n)
        s_s = _pack(states, g)
    u = [int(x) for x in untils] + [int(untils[-1])] * (g - n)
    out, snaps = _engine._run_seg_batch(stat, _pack(dps, g), s_s, u)
    return out, snaps, g


def to_host(tree):
    """A copy on the host of a tree of tensors (NamedTuples and tuples of
    them, e.g. a pack's ``Globals`` and its snapshots): one non-blocking
    copy a leaf, then one wait for the card. This is what the segmented
    runners read at each boundary, once per pack rather than once per
    lane."""
    def copy(x):
        if isinstance(x, tuple):
            parts = [copy(y) for y in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x.to("cpu", non_blocking=True, copy=True)

    out = copy(tree)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# compaction scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Lane:
    """One point's resumable execution (host-side scheduling mirror)."""
    p: SweepPoint
    dp: object                  # DynParams | AriaDyn
    cfg: EngineConfig | None    # engine family only
    bt: int = 1                 # aria ticks per batch (loop iteration)
    state: object = None        # SimState | AriaState once admitted
    now: int = 0
    iters: int = 0
    wall_us: float = 0.0


def _run_bucket_compact(family: str, stat, bpts: list[SweepPoint],
                        pad_t: int, pad_l: int, chunk_size: int,
                        slice_iters: int | None, metrics: dict,
                        wall_us: dict, dev: torch.device):
    """Run one bucket with lockstep compaction (see module docstring).

    Slices are **iteration budgets**, not sim-time windows: lanes of a grid
    typically share the horizon, so sim-time boundaries would retire every
    lane on the same slice. For the engine the budget is the ``max_iters``
    cap; for Aria, whose every loop iteration advances ``now`` by exactly
    ``batch_ticks``, the per-lane pause target is ``now + slice *
    batch_ticks``. Only the first call's budget comes from the analytic
    estimate; later budgets re-derive from the observed progress unless
    ``slice_iters`` pins them.
    """
    queue: list[_Lane] = []
    ests = sorted(((_est_iters(p), i) for i, p in enumerate(bpts)),
                  key=lambda ei: ei[0], reverse=True)
    for _, i in ests:
        p = bpts[i]
        if family == "engine":
            cfg = _engine_config(p)
            _, dp = _engine.split_config(cfg, pad_threads=pad_t,
                                         pad_len=pad_l, device=dev)
            queue.append(_Lane(p=p, dp=dp, cfg=cfg))
        else:
            _, dp = _aria.split_aria(
                AriaConfig(p.workload, p.costs, p.n_threads, p.horizon),
                pad_threads=pad_t, pad_len=pad_l, device=dev)
            queue.append(_Lane(p=p, dp=dp, cfg=None,
                               bt=_aria.batch_ticks(p.workload, p.costs)))
    est_max = max(ests[0][0], 1.0)
    budget = slice_iters or max(256, int(2.0 * est_max / DEFAULT_SLICES))
    adaptive = slice_iters is None

    active: list[_Lane] = []
    n_calls = n_repacks = lane_iters = 0
    repack_log: list[tuple] = []
    # When a call retires nobody, the next call runs the same lanes in the
    # same slots: reuse the packed states instead of re-stacking them.
    packed = None               # (packed states, width)
    while queue or active:
        while queue and len(active) < chunk_size:
            ln = queue.pop(0)
            ln.state = (_engine.init_state_dyn(stat, ln.dp)
                        if family == "engine"
                        else _aria.init_aria_state(stat, dev))
            active.append(ln)
        n = len(active)
        # full pools run at exactly chunk_size; the drain tail descends
        # the pow2 width ladder below it
        g = min(_pow2ceil(n), chunk_size)
        t0 = time.perf_counter()
        phases = None
        if packed is not None:
            s_s, g_run = packed
        else:
            g_run = g
            s_s = _pack([ln.state for ln in active], g_run)
        if family == "engine":
            dps = [ln.dp._replace(max_iters=min(ln.iters + budget,
                                                ln.cfg.max_iters))
                   for ln in active]
            out = _engine._run_batch(stat, _pack(dps, g_run), s_s)
            nows = out.g.now.tolist()
            iters = out.g.iters.tolist()
            if any(ln.cfg.drain for ln in active):
                phases = out.th.phase.cpu().numpy()
        else:
            # clamp to the horizon: the condition ANDs `now < horizon`
            # anyway, and an unclamped target can overflow i32
            untils = [min(ln.now + budget * ln.bt, ln.p.horizon)
                      for ln in active]
            out = _aria._run_seg_batch(
                stat, _pack([ln.dp for ln in active], g_run), s_s,
                untils + [untils[-1]] * (g_run - n))
            nows = out.now.tolist()

        per_lane_us = (time.perf_counter() - t0) * 1e6 / n
        max_d = 0
        done_mask = []
        for i, ln in enumerate(active):
            if family == "engine":
                delta = iters[i] - ln.iters
                ln.iters, ln.now = iters[i], nows[i]
                done = _engine.run_finished(
                    ln.cfg, ln.now, ln.iters,
                    phase=None if phases is None else phases[i])
            else:
                delta = (nows[i] - ln.now) // max(ln.bt, 1)
                ln.now = nows[i]
                done = ln.now >= ln.p.horizon
            max_d = max(max_d, delta)
            ln.wall_us += per_lane_us
            if done:
                metrics[ln.p.name] = (
                    extract_globals(ln.p.protocol, ln.p.n_threads, out.g,
                                    lane=i)
                    if family == "engine"
                    else extract_aria(ln.p.n_threads, take_lane(
                        _aria.metrics_view(out), i)))
                wall_us[ln.p.name] = ln.wall_us
                ln.state = None
            done_mask.append(done)
        retired = sum(done_mask)
        if retired:                     # composition changes: unpack
            survivors = []
            for i, ln in enumerate(active):
                if not done_mask[i]:
                    ln.state = take_lane(out, i)
                    survivors.append(ln)
            active = survivors
            packed = None
        else:                           # unchanged: reuse the pack as-is
            packed = (out, g_run)
        n_calls += 1
        lane_iters += g_run * max_d
        repack_log.append((n, g_run, max_d))
        if retired and active:
            n_repacks += 1
        if adaptive and active:
            # Re-estimate the budget from the OBSERVED call: each
            # survivor's remaining iterations extrapolate linearly in
            # sim-time; the densest re-sets the budget at 1/DEFAULT_SLICES
            # of its projected remainder, floored at this call's
            # max_delta_iters. Results never depend on the budget.
            rem = 0.0
            for ln in active:
                if family == "engine":
                    left = max(_engine.stop_ticks(ln.cfg) - ln.now, 0)
                    rem = max(rem, ln.iters * left / max(ln.now, 1))
                else:
                    rem = max(rem, (ln.p.horizon - ln.now)
                              / max(ln.bt, 1))
            budget = max(256, max_d, int(rem / DEFAULT_SLICES))
    return n_calls, n_repacks, lane_iters, tuple(repack_log)


def _run_bucket_chunks(family: str, bpts: list[SweepPoint],
                       pad_t: int, pad_l: int, chunk_size: int,
                       metrics: dict, wall_us: dict, dev: torch.device):
    """The sort-then-cut path (``compact=False`` / sequential)."""
    n_chunks = 0
    lane_iters = 0
    for chunk in _make_chunks(bpts, chunk_size):
        n_real = len(chunk)
        # pad partial chunks (replicated last lane) to a pow2 width capped
        # at chunk_size
        g = min(_pow2ceil(n_real), chunk_size)
        chunk = chunk + [chunk[-1]] * (g - n_real)
        t0 = time.perf_counter()
        if family == "engine":
            parts = [_engine.split_config(_engine_config(p),
                                          pad_threads=pad_t,
                                          pad_len=pad_l, device=dev)
                     for p in chunk]
            stat = parts[0][0]
            out = _engine._run_batch(
                stat, stack_lanes([dp for _, dp in parts]),
                stack_lanes([_engine.init_state_dyn(stat, dp)
                             for _, dp in parts]))
            host = out.g
            lane_iters += g * int(out.g.iters.max())
        else:
            parts = [_aria.split_aria(
                AriaConfig(p.workload, p.costs, p.n_threads, p.horizon),
                pad_threads=pad_t, pad_len=pad_l, device=dev)
                for p in chunk]
            stat = parts[0][0]
            out = _aria._run_batch(stat, stack_lanes([dp for _, dp in parts]))
            host = _aria.metrics_view(out)
            nows = out.now.tolist()
            lane_iters += g * max(
                nows[j] // max(_aria.batch_ticks(p.workload, p.costs), 1)
                for j, p in enumerate(chunk[:n_real]))
        per_pt = (time.perf_counter() - t0) * 1e6 / n_real
        for j, p in enumerate(chunk[:n_real]):
            if family == "engine":
                metrics[p.name] = extract_globals(p.protocol, p.n_threads,
                                                  host, lane=j)
            else:
                metrics[p.name] = extract_aria(p.n_threads,
                                               take_lane(host, j))
            wall_us[p.name] = per_pt
        n_chunks += 1
    return n_chunks, 0, lane_iters, ()


# ---------------------------------------------------------------------------
# lanes across devices
# ---------------------------------------------------------------------------

def _shard_lanes(n_lanes: int, n_dev: int) -> tuple[list[list[int]], int]:
    """The reference's ``_shard_lanes`` rule on a lane axis of ``n_lanes``:
    pad it to ``g``, the next multiple of ``n_dev``, by replicating the last
    lane, and give device ``i`` the lanes ``[i*g/n_dev, (i+1)*g/n_dev)``.
    Returns (each device's lane indices, pad slots as ``n_lanes - 1``;
    ``g``). One device: the lanes as they are."""
    if n_dev <= 1:
        return [list(range(n_lanes))], n_lanes
    g = -(-n_lanes // n_dev) * n_dev
    idx = list(range(n_lanes)) + [n_lanes - 1] * (g - n_lanes)
    w = g // n_dev
    return [idx[i * w:(i + 1) * w] for i in range(n_dev)], g


def _split(points: list[SweepPoint], thread_bucket, n_dev: int
           ) -> list[list[SweepPoint]]:
    """Each device's points: every bucket's lanes, in the compaction
    queue's order (densest estimate first), split by :func:`_shard_lanes`
    with pad slots dropped. Bucket ``b``'s block ``j`` goes to device
    ``(j + b) % n_dev``, so the densest block of each bucket lands on a
    different device (a pack runs until its slowest lane finishes)."""
    buckets: dict[tuple, list[SweepPoint]] = {}
    for p in points:
        buckets.setdefault(_bucket_key(p, thread_bucket), []).append(p)
    shares: list[list[SweepPoint]] = [[] for _ in range(n_dev)]
    for b, bpts in enumerate(buckets.values()):
        order = sorted(bpts, key=_est_iters, reverse=True)
        blocks, _ = _shard_lanes(len(order), n_dev)
        seen: set[int] = set()
        for j, block in enumerate(blocks):
            for i in block:
                if i not in seen:           # pad slots are never run
                    seen.add(i)
                    shares[(j + b) % n_dev].append(order[i])
    return shares


def _shard_worker(points: list[SweepPoint], device: str, kw: dict
                  ) -> SweepResults:
    """One device's share, run in its own spawned process."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    return run_sweep(points, shard=False, device=device, **kw)


def _merge_buckets(parts: list[SweepResults]) -> list[BucketInfo]:
    """One ``BucketInfo`` a bucket over the devices' shares: counts summed,
    the wall the longest share's, the repack logs concatenated."""
    merged: dict[tuple, BucketInfo] = {}
    for part in parts:
        for b in part.buckets:
            key = (b.family, b.kind, b.n_rows, b.pad_threads, b.pad_len)
            m = merged.get(key)
            merged[key] = b if m is None else dataclasses.replace(
                m, n_points=m.n_points + b.n_points,
                n_chunks=m.n_chunks + b.n_chunks,
                wall_s=max(m.wall_s, b.wall_s),
                n_repacks=m.n_repacks + b.n_repacks,
                lane_iters=m.lane_iters + b.lane_iters,
                repack_log=m.repack_log + b.repack_log)
    return list(merged.values())


def _run_sharded(points: list[SweepPoint], devices: list, thread_bucket,
                 kw: dict) -> SweepResults:
    """:func:`run_sweep` over several devices: one spawned worker process a
    device, each running its share (:func:`_split`) on its device."""
    t0 = time.perf_counter()
    shares = _split(points, thread_bucket, len(devices))
    work = [(share, str(d)) for share, d in zip(shares, devices) if share]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(work), mp_context=ctx) as pool:
        futs = [pool.submit(_shard_worker, share, d,
                            dict(kw, thread_bucket=thread_bucket))
                for share, d in work]
        parts = [f.result() for f in futs]
    metrics, wall_us = {}, {}
    for part in parts:
        metrics.update(part.metrics)
        wall_us.update(part.wall_us)
    return SweepResults(points=points, metrics=metrics, wall_us=wall_us,
                        buckets=_merge_buckets(parts), n_compiles=0,
                        wall_s=time.perf_counter() - t0)


def run_sweep(points: Iterable[SweepPoint], *, chunk_size: int | None = None,
              thread_bucket: str = "pow2", shard: bool = True,
              compact: bool | None = None, slice_iters: int | None = None,
              verbose: bool = False, device=None,
              devices: Sequence | None = None) -> SweepResults:
    """Run every point on ``device`` (default: CUDA), packed per shape
    bucket. Order is preserved.

    ``chunk_size`` bounds the lanes per pack; the default is
    :func:`_auto_chunk`'s. ``compact`` picks the execution path: ``None``
    (default) enables the lockstep compaction scheduler whenever lanes are
    packed (``chunk_size > 1``); ``False`` forces sort-then-cut chunking;
    ``True`` forces compaction even at width 1. ``slice_iters`` overrides
    the per-call iteration budget (default: ~1/8 of the densest lane's
    estimate, floor 256). ``thread_bucket`` picks the bucketing strategy
    (see :func:`_bucket_key`). ``shard`` splits the lanes over ``devices``
    (default: every visible card when ``device`` is CUDA), one worker
    process a device (see the module docstring; ``devices`` may name one
    card twice); with one device it does nothing, as in the reference.
    Results are bit-identical on every path. The workers are spawned, so a
    script that calls ``run_sweep`` where more than one card is visible (or
    with ``devices=``) must do so under ``if __name__ == "__main__":``;
    ``shard=False`` or ``device="cuda:0"`` keeps the run in the caller's
    process on one card.
    """
    points = list(points)
    names = [p.name for p in points]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate sweep point names: {dup[:5]}")
    for p in points:            # fail fast, before any bucket burns time
        if p.protocol not in KNOWN_PROTOCOLS:
            raise ValueError(
                f"sweep point {p.name!r}: unknown protocol "
                f"{p.protocol!r} (known: {', '.join(KNOWN_PROTOCOLS)})")
        if p.protocol == "aria":
            _check_aria_point(p)
    if slice_iters is not None and slice_iters <= 0:
        raise ValueError(f"slice_iters={slice_iters}: must be a positive "
                         "iteration budget (or None for the adaptive "
                         "default)")
    dev = resolve(device)
    if devices is None and dev.type == "cuda" and dev.index is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if shard and devices is not None and len(devices) > 1:
        return _run_sharded(points, [resolve(d) for d in devices],
                            thread_bucket,
                            dict(chunk_size=chunk_size, compact=compact,
                                 slice_iters=slice_iters, verbose=verbose))
    chunk_size = chunk_size or _auto_chunk(dev)
    if compact is None:
        compact = chunk_size > 1

    buckets: dict[tuple, list[int]] = {}
    for i, p in enumerate(points):
        buckets.setdefault(_bucket_key(p, thread_bucket), []).append(i)

    metrics: dict[str, SimResult] = {}
    wall_us: dict[str, float] = {}
    infos: list[BucketInfo] = []
    t_start = time.perf_counter()

    for key, idxs in buckets.items():
        family, kind, n_rows = key[:3]
        bpts = [points[i] for i in idxs]
        if len(key) > 3:        # pow2 buckets pad to the (stable) cap
            pad_t, pad_l = key[3], key[4]
        else:                   # "max": pad to the grid max
            pad_t = max(p.n_threads for p in bpts)
            pad_l = max(p.workload.txn_len for p in bpts)
        t_bucket = time.perf_counter()

        if compact:
            stat = _engine.StaticShape(kind=kind, n_threads=pad_t,
                                       txn_len=pad_l, n_rows=n_rows)
            n_chunks, n_rep, lit, rlog = _run_bucket_compact(
                family, stat, bpts, pad_t, pad_l, chunk_size, slice_iters,
                metrics, wall_us, dev)
        else:
            n_chunks, n_rep, lit, rlog = _run_bucket_chunks(
                family, bpts, pad_t, pad_l, chunk_size, metrics, wall_us,
                dev)

        infos.append(BucketInfo(
            family=family, kind=kind, n_rows=n_rows, pad_threads=pad_t,
            pad_len=pad_l, n_points=len(bpts), n_chunks=n_chunks,
            wall_s=time.perf_counter() - t_bucket, compacted=compact,
            n_repacks=n_rep, lane_iters=lit, repack_log=rlog))
        if verbose:
            b = infos[-1]
            print(f"# sweep bucket {family}/{kind}/R{n_rows}: "
                  f"{b.n_points} pts, T<={pad_t}, L<={pad_l}, "
                  f"{b.n_chunks} call(s), {b.n_repacks} repack(s), "
                  f"{b.lane_iters} lane-iters, {b.wall_s:.1f}s")

    return SweepResults(
        points=points, metrics=metrics, wall_us=wall_us, buckets=infos,
        n_compiles=0, wall_s=time.perf_counter() - t_start)


def summarize(res: SweepResults, names: Sequence[str] | None = None
              ) -> list[str]:
    """CSV rows (``name,us_per_call,derived``) in benchmark format."""
    return [bench_row(name, res.wall_us[name], res.metrics[name])
            for name in (names if names is not None else res.names())]
