"""Discrete-time concurrency-control engine in PyTorch.

The port of ``repro.core.lock.engine``: T database worker threads run
transactions over R rows under one of six locking protocols (MySQL-2PL, O1,
O2 queue locking, TXSQL group locking, Bamboo, Brook-2PL), tick-accurately,
with all state in tensors. The modelling is the reference's (ticket queues
per row, per-row aggregates re-derived every iteration from the per-thread
ticket table, commit order = update order, counter-valued rows) and every
``SimState`` leaf equals the reference's bit for bit; see the reference
module's docstring for the model itself.

What differs is the execution, not the semantics:

* A lane axis. The step runs G configurations at once with a leading axis
  on every leaf ((G, T), (G, T, L), (G, R)); ``simulate()`` is the pack of
  one. :class:`DynParams` of one config hold host scalars; stacked over G
  lanes (:func:`stack_lanes`) they hold numpy (G,) arrays. The step sees
  each value as a host scalar when every lane of the pack agrees on it,
  else as a (G, 1) tensor in the reference's dtype. A protocol flag all
  lanes agree on is a host ``if`` (a disabled branch is not computed); a
  flag they differ on selects per lane with ``torch.where``, as the
  reference's ``lax.cond`` does under ``vmap``.
* The loop is a host ``while`` whose condition reads one (G,) device bool
  per iteration (the reference's ``_make_cond``); lanes whose condition is
  false are frozen by a per-lane select on every leaf, as
  ``vmap(while_loop)`` freezes them, so a frozen lane's ``iters`` does not
  advance and a pack paused at ``max_iters`` resumes on the same steps.
* Segment reductions are ``scatter_reduce`` into buffers pre-filled with the
  int32 extremes, which is what ``jax.ops.segment_min/max`` leave in rows no
  slot touches (not the engine's ``INF``). Keys index a flat (G * R,) view
  with an int64 lane offset, and reductions that share an index are stacked
  into one scatter over an (n * G * R,) buffer.
* JAX gathers clamp out-of-range indices and ``mode="drop"`` scatters drop
  them; torch does neither, so key indices are clamped for gathers and
  masked for scatters. Generated keys always lie in [0, R), so both guards
  are the identity on every state the engine reaches.
* ``_hist_bucket`` (``jnp.log`` in the reference) and ``_q_bucket``
  (``jnp.log2``) are integer threshold tables, so no device logarithm
  decides a bucket edge.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ...device import resolve
from .costs import CostModel, ProtocolParams, protocol_params
from .workload import (WorkloadSpec, DynWorkload, dyn_workload, gen_txn_lanes,
                       will_abort_dyn)

I32 = torch.int32
F32 = torch.float32
INF = 2**30
NOTK = -1                     # "no ticket"
IMAX = 2**31 - 1              # empty-segment fill of segment_min
IMIN = -2**31                 # empty-segment fill of segment_max
N_HIST = 64
HIST_BASE = 1.3

# thread phases
START, WAIT, EXEC, CWAIT, COMMIT, RBACK, RBWAIT, BACKOFF, ARRIVE, HALT = \
    range(10)

# tick attribution: every thread-tick lands in one (branch, bin) cell, so
# sum(Globals.tb) == T * Globals.now (i32, exact mod 2**32).
N_TB = 7
TB_EXEC, TB_LOCKWAIT, TB_COMMITWAIT, TB_ROLLBACK, TB_DETECT, TB_SYNC, \
    TB_IDLE = range(N_TB)
TB_NAMES = ("exec", "lock_wait", "commit_wait", "rollback", "detection",
            "sync", "idle")
TB_BRANCHES = ("cold", "hot")
_TB_PHASE_BIN = np.array(
    [TB_IDLE, TB_LOCKWAIT, TB_EXEC, TB_COMMITWAIT, TB_SYNC,
     TB_ROLLBACK, TB_ROLLBACK, TB_ROLLBACK, TB_IDLE, TB_IDLE],
    dtype=np.int32)
# log2 buckets of the segment snapshot's histograms: bucket 0 = empty,
# bucket b >= 1 = count in [2**(b-1), 2**b); the last bucket is open.
N_QHIST = 12
# The reference truncates an f32 log2; for the integers it sees (< 2**24,
# exact in f32, log2 exact at powers of two) that is the count of powers of
# two <= v, which this table gives without a device log2.
Q_THRESHOLDS = np.asarray([2**k for k in range(N_QHIST - 1)], np.int32)

# per-record contention attribution: ca[CA_WAIT].sum() ==
# tb[:, TB_LOCKWAIT].sum() (i32, exact mod 2**32).
N_CA = 6
CA_WAIT, CA_GRANTS, CA_TIMEOUTS, CA_VICTIMS, CA_QSUM, CA_QMAX = range(N_CA)
CA_NAMES = ("wait_ticks", "grants", "timeouts", "victims",
            "queue_sum", "queue_max")

# stage ablation (the step profiler's seam, ``repro_torch.obs.prof``):
# ``_make_step_events(..., ablate={stage})`` replaces one stage's compute by
# a shape-correct stand-in. Each stand-in is the identity on the step when
# the stage's work is absent (protocol flag off, read-only workload, txn_len
# 1), and the empty set is the production step, call for call.
PROF_STAGES = (
    "dup_analysis",    # gen_txn_lanes' (T, L, L) pairwise dup/last-use scan
    "deadlock_walk",   # the 8-hop waits-for cycle walk (stage 1b)
    "ticket_grant",    # grant-rule masks (4a) + FIFO ticket argsort (8)
    "commit_cursor",   # _derive: cc/top/us/holder T*L -> R seg reductions
    "group_hotspot",   # group-lock / group-commit / hotspot-detect branches
    "tick_charge",     # TickBreakdown (and contention) scatters (stage 5)
)


def _hist_thresholds() -> np.ndarray:
    """Smallest latency of each bucket 1..N_HIST-1 under the reference's
    ``trunc(f32(log(f32(lat) + 1)) / f32(log(1.3)))``, emulated in float64
    (a correctly rounded f32 log and an f32 quotient)."""
    c = np.float64(np.float32(math.log(HIST_BASE)))

    def bucket(lat):
        lg = np.float32(math.log(np.float64(np.float32(lat + 1.0))))
        return int(np.float32(np.float64(lg) / c))

    thr = []
    for b in range(1, N_HIST):
        t = max(math.ceil(HIST_BASE ** b - 1) - 4, 0)
        while t > 0 and bucket(t) >= b:
            t -= 1
        while bucket(t) < b:
            t += 1
        thr.append(t)
    return np.asarray(thr, np.int32)


HIST_THRESHOLDS = _hist_thresholds()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    protocol: ProtocolParams
    costs: CostModel
    workload: WorkloadSpec
    n_threads: int = 64
    horizon: int = 2_000_000          # ticks (0.1us) => 0.2s simulated
    p_abort: float = 0.0              # injected commit-time aborts (Fig 10)
    drain: bool = False               # run until all threads quiesce
    max_iters: int = 1_500_000
    seed: int = 0
    attrib: bool = False              # per-record contention accumulator


class StaticShape(NamedTuple):
    """The shapes and the workload kind."""
    kind: str           # workload kind
    n_threads: int      # padded thread count T
    txn_len: int        # padded op-slot count L
    n_rows: int         # key space R


class DynParams(NamedTuple):
    """Per-config parameters, field for field the reference's.

    For one config, scalars are host values (floats rounded to f32, as the
    reference holds them) and ``txn_cap`` is a (T,) i32 tensor on the
    engine's device; ``n_active`` masks padded threads (tid >= n_active
    start in HALT). Stacked over G lanes (:func:`stack_lanes`), scalars are
    numpy (G,) arrays in the reference's dtypes and ``txn_cap`` is (G, T).
    """
    # --- protocol ---
    lock_base: int
    grant_cost: int
    dd_coeff: float
    has_detection: bool
    hot_queue: bool
    early_release: bool
    early_all: bool
    group_lock: bool
    group_commit: bool
    dynamic_batch: bool
    batch_size: int
    hot_threshold: int
    proactive_abort: bool
    ordered_acquire: bool
    per_op_release: bool
    wait_timeout: int
    commit_wait_timeout: int
    # --- costs ---
    op_exec: int
    read_exec: int
    commit_base: int
    sync_lat: int
    rb_base: int
    rb_per_op: int
    backoff: int
    arrival_rate: float
    rb_turn_timeout: int
    # --- run ---
    horizon: int
    p_abort: float
    drain: bool
    max_iters: int
    n_active: int
    txn_cap: torch.Tensor
    attrib: bool
    # --- workload ---
    wl: DynWorkload


def _f32(v) -> float:
    return float(np.float32(v))


def split_config(cfg: EngineConfig, pad_threads: int | None = None,
                 pad_len: int | None = None, device=None
                 ) -> tuple[StaticShape, DynParams]:
    """EngineConfig -> (shapes, per-config params on ``device``), padded to
    ``pad_threads`` threads and ``pad_len`` op slots. Padded threads start
    in HALT; padded slots stay inert behind ``wl.txn_len``."""
    dev = resolve(device)
    p, c, w = cfg.protocol, cfg.costs, cfg.workload
    T = pad_threads or cfg.n_threads
    L = pad_len or w.txn_len
    assert T >= cfg.n_threads and L >= w.txn_len
    stat = StaticShape(kind=w.kind, n_threads=T, txn_len=L, n_rows=w.n_rows)
    dp = DynParams(
        lock_base=int(p.lock_base), grant_cost=int(p.grant_cost),
        dd_coeff=_f32(p.dd_coeff), has_detection=bool(p.has_detection),
        hot_queue=bool(p.hot_queue), early_release=bool(p.early_release),
        early_all=bool(p.early_all), group_lock=bool(p.group_lock),
        group_commit=bool(p.group_commit),
        dynamic_batch=bool(p.dynamic_batch),
        batch_size=int(p.batch_size), hot_threshold=int(p.hot_threshold),
        proactive_abort=bool(p.proactive_abort),
        ordered_acquire=bool(p.ordered_acquire),
        per_op_release=bool(p.per_op_release),
        wait_timeout=int(p.wait_timeout),
        commit_wait_timeout=int(p.commit_wait_timeout),
        op_exec=int(c.op_exec), read_exec=int(c.read_exec),
        commit_base=int(c.commit_base), sync_lat=int(c.sync_lat),
        rb_base=int(c.rb_base), rb_per_op=int(c.rb_per_op),
        backoff=int(c.backoff), arrival_rate=_f32(c.arrival_rate),
        rb_turn_timeout=int(c.rb_turn_timeout),
        horizon=int(cfg.horizon), p_abort=_f32(cfg.p_abort),
        drain=bool(cfg.drain), max_iters=int(cfg.max_iters),
        n_active=int(cfg.n_threads),
        txn_cap=torch.full((T,), INF, dtype=I32, device=dev),
        attrib=bool(cfg.attrib),
        wl=dyn_workload(w, dev),
    )
    return stat, dp


class Threads(NamedTuple):
    phase: torch.Tensor      # (T,)
    work: torch.Tensor       # (T,) remaining ticks in paying phase
    op: torch.Tensor         # (T,) current op slot
    txn: torch.Tensor        # (T,) txn counter
    tstart: torch.Tensor     # (T,) first-attempt start tick
    wstart: torch.Tensor     # (T,) wait start tick
    willab: torch.Tensor     # (T,) bool: injected abort at commit
    forced: torch.Tensor     # (T,) bool: forced abort pending
    vabort: torch.Tensor     # (T,) bool: abort is voluntary
    retry: torch.Tensor      # (T,) bool: current txn is a retry
    keys: torch.Tensor       # (T, L)
    iswr: torch.Tensor       # (T, L) bool
    dup: torch.Tensor        # (T, L) bool
    ticket: torch.Tensor     # (T, L) ticket or -1
    applied: torch.Tensor    # (T, L) bool
    early: torch.Tensor      # (T, L) bool: early-release semantics at apply
    committing: torch.Tensor  # (T, L) bool: entered the commit queue
    lastu: torch.Tensor      # (T, L) bool: slot is its key's last use
    released: torch.Tensor   # (T, L) bool: ticket retired at release point
    nops: torch.Tensor       # (T,)
    detleft: torch.Tensor    # (T,) detection ticks left in current EXEC


class Rows(NamedTuple):
    nt: torch.Tensor         # (R,) next ticket
    updating: torch.Tensor   # (R,) bool: an update is executing
    hot: torch.Tensor        # (R,) bool
    gleader: torch.Tensor    # (R,) leader ticket of OPEN group, -1 if closed
    gcount: torch.Tensor     # (R,) members granted in open group
    casc: torch.Tensor       # (R,) cascade low ticket (INF = none)
    batch_end: torch.Tensor  # (R,) group-commit batch completion tick
    batch_n: torch.Tensor    # (R,) members in the open commit batch
    applied_val: torch.Tensor    # (R,) net applied increments
    committed_val: torch.Tensor  # (R,) committed increments


class Globals(NamedTuple):
    now: torch.Tensor
    commits: torch.Tensor
    user_aborts: torch.Tensor
    forced_aborts: torch.Tensor
    lock_ops: torch.Tensor
    wait_ticks: torch.Tensor     # f32 (lock-wait thread-ticks)
    busy_ticks: torch.Tensor     # f32 (executing/committing thread-ticks)
    lat_sum: torch.Tensor        # f32
    hist: torch.Tensor           # (N_HIST,) i32 latency histogram
    dd_ticks: torch.Tensor       # deadlock-detection ticks paid on grants
    iters: torch.Tensor
    tb: torch.Tensor             # (len(TB_BRANCHES), N_TB) i32
    ca: torch.Tensor             # (N_CA, R) i32 per-record contention


class SimState(NamedTuple):
    th: Threads
    rows: Rows
    g: Globals


class SegSnapshot(NamedTuple):
    """Instantaneous contention telemetry at a segment boundary (counters
    come from differencing ``Globals`` across it instead)."""
    max_qlen: torch.Tensor   # () i32  longest row wait queue
    n_hot: torch.Tensor      # () i32  rows currently promoted hot
    n_live: torch.Tensor     # () i32  live tickets across all rows
    n_waiting: torch.Tensor  # () i32  threads in a lock/commit wait phase
    wait_hist: torch.Tensor  # (N_QHIST,) rows by wait-queue depth (sums to R)
    occ_hist: torch.Tensor   # (N_QHIST,) HOT rows by live-ticket occupancy


# ---------------------------------------------------------------------------
# lanes: stacking, slicing, and the step's view of a pack's parameters
# ---------------------------------------------------------------------------

def _is_tuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _np_dtype(v):
    if isinstance(v, (bool, np.bool_)):
        return np.bool_
    if isinstance(v, (float, np.floating)):
        return np.float32
    return np.int32


def stack_lanes(trees):
    """Stack one-lane NamedTuple trees (params or states) along a new
    leading lane axis: tensors with ``torch.stack``, host scalars into
    numpy arrays in the reference's dtypes (bool, i32, f32)."""
    first = trees[0]
    if _is_tuple(first):
        return type(first)(*(stack_lanes([t[i] for t in trees])
                             for i in range(len(first))))
    if torch.is_tensor(first):
        return torch.stack(list(trees))
    return np.asarray(trees, dtype=_np_dtype(first))


def take_lane(tree, i: int):
    """Lane ``i`` of a stacked tree: tensors sliced (a view), numpy lanes
    back to host scalars."""
    if _is_tuple(tree):
        return type(tree)(*(take_lane(x, i) for x in tree))
    if torch.is_tensor(tree):
        return tree[i]
    v = np.asarray(tree)[i]
    if v.dtype == np.bool_:
        return bool(v)
    return float(v) if v.dtype.kind == "f" else int(v)


def _unsqueeze(tree):
    return type(tree)(*(_unsqueeze(x) if _is_tuple(x) else x[None]
                        for x in tree))


def _lane_value(vals: np.ndarray, dtype, dev, G: int):
    """One parameter across a pack: a host scalar when every lane agrees,
    else a (G, 1) tensor of ``dtype`` on ``dev``."""
    vals = np.asarray(vals).reshape(-1)
    if (vals == vals[0]).all():
        v = vals[0]
        if dtype == torch.bool:
            return bool(v)
        return float(np.float32(v)) if dtype == F32 else int(v)
    np_dt = {torch.bool: np.bool_, F32: np.float32, I32: np.int32,
             torch.int64: np.int64}[dtype]
    return torch.from_numpy(vals.astype(np_dt)).to(dev).view(G, 1)


_TORCH_DTYPE = {np.bool_: torch.bool, np.float32: F32, np.int32: I32}


def _lane_view(dp, G: int, batched: bool, dev) -> SimpleNamespace:
    """Per-lane view of a (stacked or one-config) parameter tuple: scalars
    via :func:`_lane_value`, tensors with a leading lane axis. The workload
    ``seed`` is int64 (the hash salt is formed in int64 and masked)."""
    out = {}
    for f, v in zip(dp._fields, dp):
        if _is_tuple(v):
            out[f] = _lane_view(v, G, batched, dev)
        elif torch.is_tensor(v):
            out[f] = v if batched else v[None]
        else:
            vals = np.asarray(v) if batched else np.asarray(
                [v], dtype=_np_dtype(v))
            dt = torch.int64 if f == "seed" else _TORCH_DTYPE[
                vals.dtype.type]
            out[f] = _lane_value(vals, dt, dev, G)
    return SimpleNamespace(**out)


def _lanes(dp: DynParams) -> SimpleNamespace:
    """The step's view of ``dp`` (one config, or G stacked lanes), plus the
    per-lane values the reference derives: the stop time, the arrival
    interval and the group-commit switch."""
    batched = dp.txn_cap.dim() == 2
    dev = dp.txn_cap.device
    G = dp.txn_cap.shape[0] if batched else 1
    lp = _lane_view(dp, G, batched, dev)
    lp.G, lp.dev = G, dev
    def h(f):
        return np.broadcast_to(np.asarray(getattr(dp, f)), (G,))
    horizon = h("horizon").astype(np.int64)
    drain_stop = horizon + 3 * np.maximum(h("wait_timeout"), horizon)
    stop = np.where(h("drain"), drain_stop, horizon)
    assert (stop < 2**31).all(), "drain stop time overflows i32"
    lp.stop_time = _lane_value(stop, I32, dev, G)
    # fixed-TPS open loop: n_active (not the padded T) over the rate sets
    # the per-thread arrival interval, in f32 as the reference divides
    rate = h("arrival_rate").astype(np.float32)
    rate_on = rate > 0
    interval = [max(int(np.float32(n) / np.float32(r if on else 1.0)), 1)
                for n, r, on in zip(h("n_active"), rate, rate_on)]
    lp.rate_on = _lane_value(rate_on, torch.bool, dev, G)
    lp.interval = _lane_value(np.asarray(interval), I32, dev, G)
    lp.gcommit = _lane_value(h("group_commit") & (h("sync_lat") > 0),
                             torch.bool, dev, G)
    return lp


def _and(mask: torch.Tensor, flag) -> torch.Tensor:
    """``mask & flag`` with ``flag`` a host bool or a (G, 1) lane tensor."""
    if flag is True:
        return mask
    if flag is False:
        return torch.zeros_like(mask)
    return mask & flag.view(flag.shape[0], *[1] * (mask.dim() - 1))


def _sel(flag, on, off):
    """Per-lane ``where(flag, on, off)``; a host flag picks one side."""
    if flag is True:
        return on
    if flag is False:
        return off
    on = on if torch.is_tensor(on) else torch.as_tensor(on, dtype=I32)
    return torch.where(flag.view(flag.shape[0], *[1] * (on.dim() - 1)),
                       on, off)


def _where32(c, a, b) -> torch.Tensor:
    """``torch.where`` kept in i32 when both sides are host ints."""
    r = torch.where(c, a, b)
    return r if r.dtype == I32 else r.to(I32)


def _on(v) -> bool:
    """Whether any lane can take the branch of a flag or a positive value."""
    return torch.is_tensor(v) or bool(v)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class _Keys(NamedTuple):
    """A key-index tensor prepared once for the gathers and scatters that
    use it: clamped (JAX gather semantics) plus the lane offset into a flat
    (G * R,) view, and the in-range mask (drop)."""
    idx: torch.Tensor        # long, clamped to [0, R) + lane * R
    ok: torch.Tensor         # bool, raw key in [0, R)


def _keys(k: torch.Tensor, R: int) -> _Keys:
    """Keys of shape (G, ...) into the flat (G * R,) view of (G, R) rows."""
    idx = k.clamp(0, R - 1).long()
    G = k.shape[0]
    if G > 1:
        off = torch.arange(G, device=k.device) * R
        idx = idx + off.view(G, *[1] * (k.dim() - 1))
    return _Keys(idx, (k >= 0) & (k < R))


def _take(rows: torch.Tensor, k: _Keys) -> torch.Tensor:
    """``rows[lane, key]`` for (G, R) rows, in the keys' shape."""
    return torch.take(rows, k.idx)


def _seg_min(datas, valids, k: _Keys, G: int, R: int) -> torch.Tensor:
    """Stacked ``_seg_min``: [i] of the (n, G, R) result is the reference's
    ``segment_min(where(valids[i], datas[i], INF), keys)`` per lane."""
    vals = torch.cat([
        torch.where(k.ok, torch.where(v, d, INF), IMAX).reshape(-1)
        for d, v in zip(datas, valids)])
    idx = torch.cat([k.idx.reshape(-1) + i * G * R
                     for i in range(len(datas))])
    out = torch.full((len(datas) * G * R,), IMAX, dtype=I32,
                     device=idx.device)
    return out.scatter_reduce_(0, idx, vals, "amin").view(len(datas), G, R)


def _seg_max(data, valid, k: _Keys, G: int, R: int) -> torch.Tensor:
    vals = torch.where(k.ok, torch.where(valid, data, -1), IMIN)
    out = torch.full((G * R,), IMIN, dtype=I32, device=vals.device)
    return out.scatter_reduce_(0, k.idx.reshape(-1), vals.reshape(-1),
                               "amax").view(G, R)


def _seg_count(valids, k: _Keys, G: int, R: int) -> torch.Tensor:
    """Stacked ``_seg_sum`` of ones: (n, G, R) i32 counts of valid slots."""
    vals = torch.cat([(v & k.ok).to(I32).reshape(-1) for v in valids])
    idx = torch.cat([k.idx.reshape(-1) + i * G * R
                     for i in range(len(valids))])
    out = torch.zeros((len(valids) * G * R,), dtype=I32, device=idx.device)
    return out.scatter_add_(0, idx, vals).view(len(valids), G, R)


def _scat_add(target: torch.Tensor, k: _Keys, val) -> torch.Tensor:
    """``target.at[lane, k].add(val, mode="drop")`` (out of place)."""
    return target.reshape(-1).scatter_add(
        0, k.idx.reshape(-1),
        torch.where(k.ok, val, 0).reshape(-1)).view(target.shape)


def _lsum(x: torch.Tensor) -> torch.Tensor:
    """Per-lane sum over the last axis to (G,) i32, wrapping like the
    reference's i32 sums."""
    return x.sum(dim=-1).to(I32)


def _hist_bucket(lat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Latency-histogram bucket: the count of thresholds <= lat (clipped)."""
    return torch.searchsorted(thr, lat.contiguous(), right=True).clamp(
        max=N_HIST - 1)


def _q_bucket(v: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """log2 occupancy bucket: 0 -> 0, 1 -> 1, [2,4) -> 2, [4,8) -> 3, ...
    (``thr`` is :data:`Q_THRESHOLDS` on ``v``'s device)."""
    return torch.searchsorted(thr, v.contiguous(), right=True).clamp(
        max=N_QHIST - 1)


class Derived(NamedTuple):
    us: torch.Tensor          # (G, R) next grantable ticket
    cc: torch.Tensor          # (G, R) commit cursor
    top: torch.Tensor         # (G, R) highest applied ticket
    holder: torch.Tensor      # (G, R) thread holding lowest live ticket
    n_wait: torch.Tensor      # (G, R) unapplied live tickets (queue length)
    n_live: torch.Tensor      # (G, R) all live tickets
    hotof: torch.Tensor       # (G, T) row of first early applied op (-1)
    napp: torch.Tensor        # (G, T) applied op count per thread


def _derive(stat: StaticShape, group_commit, th: Threads, rows: Rows,
            kf: _Keys, ablate: frozenset = frozenset()) -> Derived:
    """Per-row aggregates of a pack's ticket tables (``group_commit`` is
    the lanes' flag: a host bool or a (G, 1) tensor)."""
    R = stat.n_rows
    G, T, L = th.keys.shape
    if "commit_cursor" in ablate:
        # profiler stand-in: every aggregate at its no-live-ticket value
        # (the identity on read-only workloads)
        dev = th.keys.device
        return Derived(
            us=rows.nt, cc=rows.nt,
            top=torch.full((G, R), NOTK, dtype=I32, device=dev),
            holder=torch.full((G, R), NOTK, dtype=I32, device=dev),
            n_wait=torch.zeros((G, R), dtype=I32, device=dev),
            n_live=torch.zeros((G, R), dtype=I32, device=dev),
            hotof=torch.full((G, T), NOTK, dtype=I32, device=dev),
            napp=torch.zeros((G, T), dtype=I32, device=dev))
    live = th.ticket >= 0
    blocking = live & (~th.applied | ~th.early)
    appl = live & th.applied
    cc_block = appl & ~th.released
    if _on(group_commit):
        cc_block = cc_block & ~_and(th.committing, group_commit)
    tid = torch.arange(T, dtype=I32, device=th.keys.device)[:, None]
    enc = th.ticket * T + tid
    us, cc, hmin = _seg_min((th.ticket, th.ticket, enc),
                            (blocking, cc_block, live), kf, G, R)
    us = torch.where(us == INF, rows.nt, us)
    cc = torch.where(cc == INF, us, cc)
    top = _seg_max(th.ticket, appl & ~th.committing, kf, G, R)
    holder = torch.where(hmin == INF, NOTK, hmin % T)
    n_wait, n_live = _seg_count((live & ~th.applied, live), kf, G, R)

    ea = appl & th.early
    first = torch.argmax(ea.to(I32), dim=2)       # first True (0 if none)
    hotof = torch.where(ea.any(dim=2),
                        th.keys.gather(2, first[..., None]).squeeze(2), NOTK)
    napp = appl.sum(dim=2).to(I32)
    return Derived(us, cc, top, holder, n_wait, n_live, hotof, napp)


# ---------------------------------------------------------------------------
# engine step
# ---------------------------------------------------------------------------

class StepEvents(NamedTuple):
    """One iteration's event masks, as :func:`_make_step_events` returns
    them: tensors the step computes anyway, named for the tracer
    (``repro_torch.obs.trace``); the untraced step drops them.

    ``grant``/``group_join``/``timeout``/``victim`` are decided at the
    start of the interval (tick ``t_pre``); ``release``/``commit``/
    ``wait_enter``/``abort`` fire at its end (``t_post``). ``row_cur`` is
    the thread's current-op row at the start of the interval, ``row_begin``
    the row of the op begun in it (``wait_enter``). ``abort`` fires when a
    rollback completes, whatever forced it. A mask of a branch that no lane
    takes is all false.
    """
    t_pre: torch.Tensor       # (G,) tick at interval start
    t_post: torch.Tensor      # (G,) tick at interval end
    row_cur: torch.Tensor     # (G, T) current-op row at interval start
    row_begin: torch.Tensor   # (G, T) row of the op begun this iteration
    grant: torch.Tensor       # (G, T) bool WAIT -> EXEC lock grant
    group_join: torch.Tensor  # (G, T) bool grant joined an open hot group
    timeout: torch.Tensor     # (G, T) bool lock/commit wait timed out
    victim: torch.Tensor      # (G, T) bool chosen as deadlock victim
    release: torch.Tensor     # (G, T) bool brook per-op early release
    commit: torch.Tensor      # (G, T) bool txn committed
    wait_enter: torch.Tensor  # (G, T) bool took a ticket, entered WAIT
    abort: torch.Tensor       # (G, T) bool rollback completed (any cause)


def _make_step_events(stat: StaticShape, lp: SimpleNamespace, until=None,
                      ablate: frozenset = frozenset()):
    """Build the tick step for a pack of G lanes (``lp`` from
    :func:`_lanes`): ``step(s) -> (SimState, StepEvents)``. Stage numbers
    and line-by-line semantics follow
    ``repro.core.lock.engine._make_step_events``; a branch whose flag is
    off in every lane is skipped on the host.

    ``until`` (a host int or a (G, 1) tensor; segmented runs) caps the
    *idle* time advance at the segment boundary: when no thread is paying
    work the jump stops at ``until``; busy steps are never split, so a
    segmented run replays the single-shot step sequence (the reference's
    docstring has the argument).

    ``ablate`` (profiler only, :data:`PROF_STAGES`) names stages whose
    compute is replaced by the reference's stand-ins; the empty set issues
    the production step's torch calls, no more.
    """
    ablate = frozenset(ablate)
    unknown = ablate - set(PROF_STAGES)
    if unknown:
        raise ValueError(f"unknown stages: {sorted(unknown)}")
    T, R, L, G = stat.n_threads, stat.n_rows, stat.txn_len, lp.G
    dev = lp.dev
    tids = torch.arange(T, dtype=I32, device=dev)
    tb_bin = torch.from_numpy(_TB_PHASE_BIN).to(dev)
    hist_thr = torch.from_numpy(HIST_THRESHOLDS).to(dev)
    lanes = torch.arange(G, device=dev)[:, None]
    tb_off = lanes * (len(TB_BRANCHES) * N_TB)
    hist_off = lanes * N_HIST
    ca_off = lanes * (N_CA * R)
    stop_time = lp.stop_time
    if until is None:
        idle_stop = None
    elif torch.is_tensor(stop_time) or torch.is_tensor(until):
        idle_stop = torch.minimum(
            torch.as_tensor(stop_time, dtype=I32, device=dev),
            torch.as_tensor(until, dtype=I32, device=dev))
    else:
        idle_stop = min(stop_time, until)
    zero_t = torch.zeros((G, T), dtype=I32, device=dev)
    false_t = torch.zeros((G, T), dtype=torch.bool, device=dev)
    # wait_timeout <= 0 disables both timeouts, per lane
    wt = lp.wait_timeout
    wt_pos = (wt > 0) if torch.is_tensor(wt) else wt > 0
    wt_on = _on(wt_pos)

    def cur(field_tl, opc):
        """Per-thread value at its current op slot (``opc`` clipped)."""
        return field_tl.gather(2, opc).squeeze(2)

    def step(s: SimState) -> tuple[SimState, StepEvents]:
        th, rows, g = s
        kf = _keys(th.keys, R)
        d = _derive(stat, lp.group_commit, th, rows, kf, ablate)
        now = g.now[:, None]

        opc = th.op.clamp(0, L - 1).long()[..., None]
        cur_key = cur(th.keys, opc)
        ck = _keys(cur_key, R)
        cur_tkt = cur(th.ticket, opc)
        in_wait = th.phase == WAIT

        # ------------------------------------------------ 1. mark aborts
        forced = th.forced
        # 1a. wait timeout (wait_timeout <= 0 disables both timeouts)
        if wt_on:
            waited = now - th.wstart
            to_fire = ((in_wait & (waited >= wt))
                       | ((th.phase == CWAIT)
                          & (waited >= lp.commit_wait_timeout)))
            to_fire = _and(to_fire, wt_pos)
            forced = forced | to_fire
        else:
            to_fire = false_t
        # 1b. deadlock detection (waits-for cycle walk, up to 8 hops); one
        # victim per cycle: its max thread id.
        holder_at = _take(d.holder, ck)
        if _on(lp.has_detection) and "deadlock_walk" not in ablate:
            succ = torch.where(in_wait, holder_at, NOTK)
            succ = torch.where(succ == tids, NOTK, succ)
            walk = succ
            mx = tids
            on_cycle = false_t
            for _ in range(8):
                ok = walk >= 0
                wi = torch.where(ok, walk, 0).long()
                mx = torch.maximum(mx, torch.where(ok, walk, -1))
                on_cycle = on_cycle | (ok & (walk == tids))
                walk = torch.where(ok & in_wait.gather(1, wi),
                                   succ.gather(1, wi), NOTK)
            victim = _and(on_cycle & (tids == mx), lp.has_detection)
            forced = forced | victim
        else:
            victim = false_t
        # 1c. proactive hot+non-hot rollback (§4.5)
        if _on(lp.proactive_abort):
            hrow = d.hotof
            hold = holder_at
            hold_ok = hold >= 0
            hold_i = torch.where(hold_ok, hold, 0).long()
            pro = (in_wait & (hrow >= 0) & hold_ok
                   & ~_take(rows.hot, ck)
                   & (d.hotof.gather(1, hold_i) == hrow) & (hold != tids))
            forced = forced | _and(pro, lp.proactive_abort)
        # 1d. cascade propagation: any applied early ticket >= casc[key]
        casc_at = _take(rows.casc, kf)
        ae = th.applied & th.early & (th.ticket >= 0)
        forced = forced | (ae & (th.ticket >= casc_at)).any(dim=2)
        # threads that cannot abort anymore (committing) stay
        forced = forced & (th.phase != COMMIT) & (th.phase != HALT)
        casc_min = _seg_min((th.ticket,), (ae & forced[..., None],), kf,
                            G, R)[0]
        casc = torch.minimum(rows.casc, casc_min)
        casc = torch.where((casc < INF) & (d.top < casc), INF, casc)

        # ------------------------------------------------ 2. divert to RBWAIT
        parkable = forced & ((th.phase == WAIT) | (th.phase == CWAIT))
        phase = torch.where(parkable, RBWAIT, th.phase)
        wstart = torch.where(parkable, now, th.wstart)

        # ------------------------------------------------ 4. grants
        # 4a. WAIT -> EXEC
        hot_w = _take(rows.hot, ck)
        if "ticket_grant" in ablate:
            # stand-in: nothing grants (the identity on read-only workloads)
            grantable = false_t
        else:
            grantable = ((phase == WAIT) & ~forced
                         & (cur_tkt == _take(d.us, ck))
                         & ~_take(rows.updating, ck)
                         & (_take(casc, ck) == INF))
        gl_f = lp.group_lock
        if _on(gl_f):
            open_leader = _take(rows.gleader, ck)
            is_leader_grant = _and(grantable & hot_w & (open_leader == NOTK),
                                   gl_f)
            is_member_grant = _and(grantable & hot_w & (open_leader != NOTK),
                                   gl_f)
        else:
            is_leader_grant = is_member_grant = false_t

        if _on(lp.has_detection):
            qlen = _take(d.n_wait, ck).to(F32)
            dd = (qlen * lp.dd_coeff).to(I32)
            if torch.is_tensor(lp.has_detection):
                dd = torch.where(lp.has_detection, dd, 0)
        else:
            dd = zero_t
        hotq = _and(hot_w, lp.hot_queue)
        if gl_f is False:
            hot_cost = lp.lock_base
        else:
            lead = is_leader_grant if gl_f is True else (
                is_leader_grant | ~gl_f)
            hot_cost = _where32(lead, lp.lock_base, lp.grant_cost)
        overhead = torch.where(hotq, hot_cost, dd + lp.lock_base)
        work = torch.where(grantable, overhead + lp.op_exec, th.work)
        phase = torch.where(grantable, EXEC, phase)
        detleft = torch.where(grantable, torch.where(hotq, 0, dd),
                              th.detleft)
        g = g._replace(
            wait_ticks=g.wait_ticks + _lsum(
                torch.where(grantable, now - wstart, 0)).to(F32),
            lock_ops=g.lock_ops + _lsum(grantable & (~hotq | is_leader_grant)),
            dd_ticks=g.dd_ticks + _lsum(torch.where(grantable & ~hotq, dd, 0)))
        upd_new = _scat_add(torch.zeros((G, R), dtype=I32, device=dev), ck,
                            grantable.to(I32)) > 0
        updating = rows.updating | upd_new

        gl, gc = rows.gleader, rows.gcount
        if _on(gl_f) and "group_hotspot" not in ablate:
            gl_on = gl.reshape(-1).scatter_reduce(
                0, ck.idx.reshape(-1),
                torch.where(ck.ok & is_leader_grant, cur_tkt, NOTK)
                .reshape(-1), "amax").view(G, R)
            gc_on = _scat_add(gc, ck, (is_leader_grant | is_member_grant)
                              .to(I32))
            close_q = gc_on >= lp.batch_size
            if _on(lp.dynamic_batch):
                close_q = close_q | _and((d.n_wait == 0) & ~upd_new,
                                         lp.dynamic_batch)
            close = (gl_on != NOTK) & close_q
            gl = _sel(gl_f, torch.where(close, NOTK, gl_on), gl)
            gc = _sel(gl_f, torch.where(close, 0, gc_on), gc)

        # 4b. CWAIT -> COMMIT (commit order on early rows; leader hold)
        is_cw = (phase == CWAIT) & ~forced
        live = th.ticket >= 0
        lae = live & th.applied & th.early
        cc_at = _take(d.cc, kf)
        order_ok = (~(lae & ~th.released) | (cc_at == th.ticket)).all(dim=2)
        no_casc = (~live | (_take(casc, kf) == INF)).all(dim=2)
        can_commit = is_cw & order_ok & no_casc
        if _on(gl_f):
            lead_open = (lae & (_take(gl, kf) == th.ticket)).any(dim=2)
            can_commit = can_commit & ~_and(lead_open, gl_f)
        vol = can_commit & th.willab
        can_commit = can_commit & ~th.willab

        base_cost = lp.commit_base + lp.sync_lat
        batch_end, batch_n = rows.batch_end, rows.batch_n
        if _on(lp.gcommit) and "group_hotspot" not in ablate:
            h_ok = d.hotof >= 0
            hk = _keys(torch.where(h_ok, d.hotof, 0), R)
            be = _take(batch_end, hk)
            join = can_commit & h_ok & (be > now)
            fresh = can_commit & h_ok & ~join
            cost = _sel(lp.gcommit, _where32(
                join, (be - now) + lp.commit_base, base_cost), base_cost)
            batch_end = _sel(lp.gcommit, batch_end.reshape(-1).scatter_reduce(
                0, hk.idx.reshape(-1),
                torch.where(hk.ok & fresh, now + lp.sync_lat, 0).reshape(-1),
                "amax").view(G, R), batch_end)
            batch_n = _sel(lp.gcommit, _scat_add(
                batch_n, hk, (can_commit & h_ok).to(I32)), batch_n)
        else:
            cost = base_cost
        phase = torch.where(can_commit, COMMIT,
                            torch.where(vol, RBWAIT, phase))
        work = torch.where(can_commit, cost, work)
        wstart = torch.where(vol, now, wstart)
        committing = th.committing | (can_commit[..., None] & th.applied)
        forced = forced | vol
        vabort = th.vabort | vol

        # ------------------------------------------------ 4c. RBWAIT->RBACK
        top_at = _take(d.top, kf)
        my_turn = (~ae | (top_at == th.ticket)).all(dim=2)
        my_turn = my_turn | ((now - wstart) >= lp.rb_turn_timeout)
        start_rb = (phase == RBWAIT) & my_turn
        phase = torch.where(start_rb, RBACK, phase)
        work = torch.where(start_rb, d.napp * lp.rb_per_op + lp.rb_base,
                           work)

        # ------------------------------------------------ 5. dt & advance
        paying = ((phase == EXEC) | (phase == COMMIT) | (phase == RBACK)
                  | (phase == BACKOFF) | (phase == ARRIVE))
        dt_pay = torch.where(paying, work, INF).amin(dim=1, keepdim=True)
        rb_exp = torch.where(phase == RBWAIT,
                             wstart + lp.rb_turn_timeout - now, INF).amin(
                                 dim=1, keepdim=True)
        texp = torch.clamp(rb_exp, min=1)
        if wt_on:
            texp = torch.minimum(texp, torch.where(
                _and(in_wait | (phase == CWAIT), wt_pos),
                wstart + wt - now, INF).amin(dim=1, keepdim=True))
        dt = torch.minimum(dt_pay, torch.clamp(texp, min=1))
        dt = torch.where((phase == START).any(dim=1, keepdim=True), 0, dt)
        # idle windows (nothing paying) stop at the segment boundary; busy
        # steps keep single-shot event timing
        cap = stop_time if until is None else _where32(
            dt_pay == INF, idle_stop, stop_time)
        dt = torch.minimum(torch.clamp(dt, min=0),
                           torch.clamp(cap - now, min=1))
        now = now + dt
        work = torch.where(paying, work - dt, work)
        n_busy = _lsum((phase == EXEC) | (phase == COMMIT)
                       | (phase == RBACK)).to(F32)
        g = g._replace(now=now.view(G), iters=g.iters + 1,
                       busy_ticks=g.busy_ticks + n_busy * dt.view(G).to(F32))

        # tick attribution: dt to exactly one (branch, bin) per thread; EXEC
        # pays its pending detection ticks first.
        is_ex = phase == EXEC
        ddpay = torch.where(is_ex, torch.minimum(detleft, dt), 0)
        detleft = detleft - ddpay
        if "tick_charge" not in ablate:
            engaged = ((phase == WAIT) | is_ex | (phase == CWAIT)
                       | (phase == COMMIT))
            branch = (engaged & _take(rows.hot, ck)).to(I32) * N_TB + tb_off
            tb = g.tb.reshape(-1).scatter_add(
                0, torch.cat([(branch + tb_bin[phase.long()]).reshape(-1),
                              (branch + TB_DETECT).reshape(-1)]).long(),
                torch.cat([torch.where(is_ex, dt - ddpay, dt).reshape(-1),
                           ddpay.reshape(-1)]))
            g = g._replace(tb=tb.view(g.tb.shape))
        # the stand-in leaves tb (and ca) untouched; detleft above still
        # evolves, so every other leaf is exact on any config
        if _on(lp.attrib) and "tick_charge" not in ablate:
            vals = torch.stack([
                torch.where(phase == WAIT, dt, 0), grantable.to(I32),
                (to_fire & in_wait).to(I32), victim.to(I32)])   # (4, G, T)
            cidx = (cur_key.clamp(0, R - 1).long() + ca_off
                    + (torch.arange(4, device=dev) * R).view(4, 1, 1))
            ca = g.ca.reshape(-1).scatter_add(
                0, cidx.reshape(-1),
                torch.where(ck.ok, vals, 0).reshape(-1)).view(G, N_CA, R)
            ca = torch.cat([ca[:, :CA_QSUM],
                            (ca[:, CA_QSUM] + d.n_wait * dt)[:, None],
                            torch.maximum(ca[:, CA_QMAX], d.n_wait)[:, None]],
                           dim=1)
            g = g._replace(ca=_sel(lp.attrib, ca, g.ca))

        done = paying & (work <= 0)

        # ------------------------------------------------ 6. completions
        # 6a. EXEC done: apply the write, advance op
        e_done = done & (phase == EXEC)
        eff_wr = cur(th.iswr, opc) & e_done & ~cur(th.dup, opc)
        eff_i = eff_wr.to(I32)
        applied_val = _scat_add(rows.applied_val, ck, eff_i)
        updating = updating & ~(_scat_add(
            torch.zeros((G, R), dtype=I32, device=dev), ck, eff_i) > 0)
        applied = th.applied.scatter(
            2, opc, (eff_wr | cur(th.applied, opc))[..., None])
        # freeze the release semantics in force when the write applied
        if lp.early_all is True:
            early_now = torch.ones_like(eff_wr)
        else:
            early_now = (_and(_take(rows.hot, ck), lp.early_release)
                         if _on(lp.early_release) else false_t)
            if torch.is_tensor(lp.early_all):
                early_now = early_now | lp.early_all
        early = th.early.scatter(
            2, opc, torch.where(eff_wr, early_now, cur(th.early, opc))
            [..., None])
        released = th.released
        if _on(lp.per_op_release):
            # Brook-2PL per-op release at the key's last use (chop.py)
            rel_now = _and(e_done & cur(th.lastu, opc) & ~forced
                           & ~th.willab, lp.per_op_release)
            rel_slot = ((th.keys == cur_key[..., None]) & (th.ticket >= 0)
                        & rel_now[..., None])
            released = released | rel_slot
            early = early | (rel_slot & applied)
        else:
            rel_now = false_t
        nop = th.op + e_done.to(I32)
        txn_done = e_done & (nop >= th.nops)
        # forced threads stop making progress after their op completes
        to_park = e_done & forced
        phase = torch.where(to_park, RBWAIT, phase)
        e_done = e_done & ~to_park
        txn_done = txn_done & ~to_park
        phase = torch.where(txn_done, CWAIT, phase)
        wstart = torch.where(txn_done, now, wstart)
        next_op = e_done & ~txn_done

        # 6b. COMMIT done: release everything, count, next txn
        c_done = done & (phase == COMMIT)
        rel = th.ticket >= 0
        committed_val = _scat_add(
            rows.committed_val, kf, (rel & applied & c_done[..., None])
            .to(I32))
        lat = now - th.tstart
        g = g._replace(
            commits=g.commits + _lsum(c_done),
            lat_sum=g.lat_sum + _lsum(torch.where(c_done, lat, 0)).to(F32),
            hist=g.hist.reshape(-1).scatter_add(
                0, (_hist_bucket(lat, hist_thr) + hist_off).reshape(-1),
                c_done.to(I32).reshape(-1)).view(g.hist.shape))

        # 6c. RBACK done: revert applied writes, release tickets
        r_done = done & (phase == RBACK)
        applied_val = _scat_add(
            applied_val, kf, -(rel & applied & r_done[..., None]).to(I32))
        g = g._replace(
            user_aborts=g.user_aborts + _lsum(r_done & vabort),
            forced_aborts=g.forced_aborts + _lsum(r_done & ~vabort))
        keep = ~(c_done | r_done)[..., None]
        ticket = torch.where(keep, th.ticket, NOTK)
        applied = applied & keep
        early = early & keep
        committing = committing & keep
        released = released & keep

        # 6d. BACKOFF done -> START; COMMIT/RBACK -> next; backoff jittered
        # per (thread, txn) to break retry lockstep
        b_done = done & (phase == BACKOFF)
        jitter = (tids * 40503 + th.txn * 9973) % 4 + 1
        phase = torch.where(c_done | b_done, START,
                            torch.where(r_done, BACKOFF, phase))
        work = torch.where(r_done, jitter * lp.backoff, work)
        txn = th.txn + (c_done | (r_done & vabort)).to(I32)
        retry = (r_done & ~vabort) | (~c_done & th.retry)
        forced = forced & ~r_done
        vabort = vabort & ~r_done
        op = torch.where(c_done | r_done, 0, nop)

        # 6e. ARRIVE done -> START
        phase = torch.where(done & (phase == ARRIVE), START, phase)

        # ------------------------------------------------ 7. START new txns
        # halt at the horizon OR when the thread's quota is exhausted
        st = phase == START
        past = (now >= lp.horizon) | (txn >= lp.txn_cap)
        phase = torch.where(st & past, HALT, phase)
        st = st & ~past
        if _on(lp.rate_on):
            # fixed-TPS open loop
            arr = txn * lp.interval + (tids * 977) % lp.interval
            early_t = _and(st & (arr > now), lp.rate_on)
            phase = torch.where(early_t, ARRIVE, phase)
            work = torch.where(early_t, arr - now, work)
            st = st & ~early_t
        keys_n, iswr_n, dup_n, lastu_n, nops_n = gen_txn_lanes(
            stat.kind, R, L, lp.wl, tids, txn,
            acq_order=lp.ordered_acquire,
            skip_analysis="dup_analysis" in ablate)
        if _on(lp.p_abort):
            wab = will_abort_dyn(lp.wl.seed, lp.p_abort, tids, txn)
            willab = torch.where(st, wab, th.willab)
        else:
            willab = th.willab & ~st
        sel = st[..., None]
        keys = torch.where(sel, keys_n, th.keys)
        iswr = torch.where(sel, iswr_n, th.iswr)
        dup = torch.where(sel, dup_n, th.dup)
        lastu = torch.where(sel, lastu_n, th.lastu)
        nops = torch.where(st, nops_n, th.nops)
        tstart = torch.where(st & ~retry, now, th.tstart)
        op = torch.where(st, 0, op)

        # ------------------------------------------------ 8. begin next op
        begin = st | next_op
        opc = op.clamp(0, L - 1).long()[..., None]
        bkey = cur(keys, opc)
        bk = _keys(bkey, R)
        b_iswr = cur(iswr, opc)
        bwr = b_iswr & ~cur(dup, opc)
        need_ticket = begin & bwr
        direct = begin & ~bwr
        phase = torch.where(direct, EXEC, phase)
        work = torch.where(direct, _where32(b_iswr, lp.op_exec, lp.read_exec),
                           work)
        detleft = torch.where(direct, 0, detleft)

        # FIFO ticket assignment with same-tick ranking (sort by key); the
        # sentinel key R sorts non-takers after every real key. enc is
        # unique within a lane, so the order is deterministic.
        if "ticket_grant" in ablate:
            # stand-in: no same-tick ranking (exact when no thread takes a
            # ticket, as on read-only workloads)
            rank = zero_t
        else:
            enc = torch.where(need_ticket, bkey, R) * T + tids
            order = torch.argsort(enc, dim=1)
            sk = bkey.gather(1, order)
            sm = need_ticket.gather(1, order)
            same = torch.cat([
                torch.zeros((G, 1), dtype=torch.bool, device=dev),
                (sk[:, 1:] == sk[:, :-1]) & sm[:, 1:] & sm[:, :-1]], dim=1)
            seg_start = torch.cummax(torch.where(same, 0, tids), dim=1).values
            rank = torch.empty((G, T), dtype=I32, device=dev).scatter_(
                1, order, tids - seg_start)
        tkt = torch.where(need_ticket, _take(rows.nt, bk) + rank, NOTK)
        nt = _scat_add(rows.nt, bk, need_ticket.to(I32))
        ticket = ticket.scatter(
            2, opc, torch.where(need_ticket, tkt, cur(ticket, opc))[..., None])
        phase = torch.where(need_ticket, WAIT, phase)
        wstart = torch.where(need_ticket, now, wstart)

        # ------------------------------------------------ 9. hotspot detect
        hot = rows.hot
        if _on(lp.hot_queue) and "group_hotspot" not in ablate:
            live3 = ticket >= 0
            d3_nwait, d3_nlive = _seg_count((live3 & ~applied, live3),
                                            _keys(keys, R), G, R)
            demote = hot & (d3_nlive == 0)
            hot = _sel(lp.hot_queue,
                       (hot | (d3_nwait > lp.hot_threshold)) & ~demote, hot)
            gl = _sel(lp.hot_queue, torch.where(demote, NOTK, gl), gl)
            gc = _sel(lp.hot_queue, torch.where(demote, 0, gc), gc)

        th = Threads(
            phase=phase, work=work, op=op, txn=txn, tstart=tstart,
            wstart=wstart, willab=willab, forced=forced, vabort=vabort,
            retry=retry, keys=keys, iswr=iswr, dup=dup, ticket=ticket,
            applied=applied, early=early, committing=committing,
            lastu=lastu, released=released, nops=nops, detleft=detleft)
        rows = Rows(
            nt=nt, updating=updating, hot=hot, gleader=gl, gcount=gc,
            casc=casc, batch_end=batch_end, batch_n=batch_n,
            applied_val=applied_val, committed_val=committed_val)
        ev = StepEvents(
            t_pre=s.g.now, t_post=g.now, row_cur=cur_key, row_begin=bkey,
            grant=grantable, group_join=is_member_grant, timeout=to_fire,
            victim=victim, release=rel_now, commit=c_done,
            wait_enter=need_ticket, abort=r_done)
        return SimState(th, rows, g), ev

    return step


def _make_step(stat: StaticShape, lp: SimpleNamespace, until=None,
               ablate: frozenset = frozenset()):
    """The untraced step: :func:`_make_step_events` without the event
    tuple (the masks are tensors the step computes anyway, so dropping them
    costs nothing)."""
    step_events = _make_step_events(stat, lp, until=until, ablate=ablate)
    return lambda s: step_events(s)[0]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def init_state_dyn(stat: StaticShape, dp: DynParams) -> SimState:
    """Initial state of one config on ``dp``'s device; padded threads start
    in HALT."""
    T, L, R = stat.n_threads, stat.txn_len, stat.n_rows
    dev = dp.txn_cap.device

    def z(shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    tids = torch.arange(T, dtype=I32, device=dev)
    b = torch.bool
    th = Threads(
        phase=torch.where(tids < dp.n_active, START, HALT).to(I32),
        work=z((T,)), op=z((T,)), txn=z((T,)), tstart=z((T,)),
        wstart=z((T,)), willab=z((T,), b), forced=z((T,), b),
        vabort=z((T,), b), retry=z((T,), b),
        keys=z((T, L)), iswr=z((T, L), b), dup=z((T, L), b),
        ticket=full((T, L), NOTK), applied=z((T, L), b),
        early=z((T, L), b), committing=z((T, L), b), lastu=z((T, L), b),
        released=z((T, L), b), nops=full((T,), L), detleft=z((T,)))
    rows = Rows(
        nt=z((R,)), updating=z((R,), b), hot=z((R,), b),
        gleader=full((R,), NOTK), gcount=z((R,)), casc=full((R,), INF),
        batch_end=z((R,)), batch_n=z((R,)), applied_val=z((R,)),
        committed_val=z((R,)))
    g = Globals(
        now=z(()), commits=z(()), user_aborts=z(()), forced_aborts=z(()),
        lock_ops=z(()), wait_ticks=z((), F32), busy_ticks=z((), F32),
        lat_sum=z((), F32), hist=z((N_HIST,)), dd_ticks=z(()),
        iters=z(()), tb=z((len(TB_BRANCHES), N_TB)), ca=z((N_CA, R)))
    return SimState(th, rows, g)


def init_state(cfg: EngineConfig, device=None) -> SimState:
    """Initial state for a single (unpadded) config."""
    return init_state_dyn(*split_config(cfg, device=device))


def _make_cond(lp: SimpleNamespace, until=None):
    """The reference's loop condition per lane: a (G,) bool tensor."""

    def cond(s: SimState) -> torch.Tensor:
        now = s.g.now[:, None]
        running = now < lp.horizon
        if _on(lp.drain):
            drained = ((s.th.phase != HALT).any(dim=1, keepdim=True)
                       & (now < lp.stop_time))
            running = _sel(lp.drain, drained, running)
        if until is not None:
            running = running & (now < until)
        running = running & (s.g.iters[:, None] < lp.max_iters)
        return running.view(-1)

    return cond


def _freeze(run: torch.Tensor, new, old):
    """Per-lane select on every leaf: finished lanes keep ``old``."""
    if _is_tuple(new):
        return type(new)(*(_freeze(run, a, b) for a, b in zip(new, old)))
    return torch.where(run.view(-1, *[1] * (new.dim() - 1)), new, old)


def _loop(cond, step, s0):
    """``vmap(lax.while_loop)``: step every lane while any lane's
    condition holds, freezing the lanes whose condition is false. The
    condition is read on the host once per iteration."""
    s = s0
    while True:
        run = cond(s)
        flags = run.tolist()
        if not any(flags):
            return s
        new = step(s)
        s = new if all(flags) else _freeze(run, new, s)


def _run_lanes(stat: StaticShape, dp: DynParams, s0: SimState,
               untils=None) -> SimState:
    """Run a pack; ``untils`` (G segment boundaries) pauses each lane."""
    lp = _lanes(dp)
    until = None if untils is None else _lane_value(
        np.asarray(untils, np.int64), I32, lp.dev, lp.G)
    return _loop(_make_cond(lp, until), _make_step(stat, lp, until), s0)


def _run_core(stat: StaticShape, dp: DynParams, s0: SimState,
              until=None) -> SimState:
    """One config's loop: the pack of one (``lax.while_loop``)."""
    s = _run_lanes(stat, dp, _unsqueeze(s0),
                   None if until is None else [until])
    return take_lane(s, 0)


def _run_dyn(stat: StaticShape, dp: DynParams, s0: SimState) -> SimState:
    return _run_core(stat, dp, s0)


def _run_batch(stat: StaticShape, dps: DynParams, s0s: SimState) -> SimState:
    """Run G stacked configs as one pack (leading axis on every leaf).

    The loop steps until every lane's condition is false, freezing finished
    lanes, so each lane's final state equals running it alone at the same
    (padded) shape. The condition is a pure function of the state, so this
    entry point is resumable: capping ``max_iters`` at ``iters + slice`` per
    call pauses lanes at an iteration budget, and resuming replays the
    identical step sequence — the sweep's compaction scheduler relies on
    it; the final states equal single-shot runs in every leaf including
    ``iters``.
    """
    return _run_lanes(stat, dps, s0s)


def stop_ticks(cfg: EngineConfig) -> int:
    """Host mirror of :func:`_stop_time` for one config."""
    if cfg.drain:
        return cfg.horizon + 3 * max(cfg.protocol.wait_timeout, cfg.horizon)
    return cfg.horizon


def run_finished(cfg: EngineConfig, now: int, iters: int,
                 phase=None) -> bool:
    """Host mirror of the loop condition (negated).

    The compaction scheduler retires a paused lane exactly when the
    single-shot loop would have exited. ``phase`` (the (T,) thread-phase
    vector) is only needed for ``drain`` runs, whose condition also ends
    when every thread HALTs.
    """
    if iters >= cfg.max_iters:
        return True
    if cfg.drain:
        live = True if phase is None else bool((np.asarray(phase)
                                                != HALT).any())
        return (not live) or now >= stop_ticks(cfg)
    return now >= cfg.horizon


def _snapshot(stat: StaticShape, s: SimState) -> SegSnapshot:
    """Per-lane :class:`SegSnapshot` of a pack's state."""
    R = stat.n_rows
    th, rows = s.th, s.rows
    G = th.keys.shape[0]
    dev = th.keys.device
    live = th.ticket >= 0
    n_wait, n_live = _seg_count((live & ~th.applied, live),
                                _keys(th.keys, R), G, R)
    waitish = ((th.phase == WAIT) | (th.phase == CWAIT)
               | (th.phase == RBWAIT))
    thr = torch.from_numpy(Q_THRESHOLDS).to(dev)
    off = torch.arange(G, device=dev)[:, None] * N_QHIST

    def hist(v, w):
        return torch.zeros((G * N_QHIST,), dtype=I32, device=dev).scatter_add_(
            0, (_q_bucket(v, thr) + off).reshape(-1), w.reshape(-1)
        ).view(G, N_QHIST)

    return SegSnapshot(
        max_qlen=n_wait.amax(dim=1).to(I32),
        n_hot=_lsum(rows.hot), n_live=_lsum(n_live), n_waiting=_lsum(waitish),
        wait_hist=hist(n_wait, torch.ones_like(n_wait)),
        occ_hist=hist(n_live, rows.hot.to(I32)))


def _run_seg_core(stat: StaticShape, dp: DynParams, s0s: SimState,
                  untils) -> tuple[SimState, SegSnapshot]:
    s = _run_lanes(stat, dp, s0s, untils)
    return s, _snapshot(stat, s)


def _run_seg_dyn(stat: StaticShape, dp: DynParams, s0: SimState,
                 until) -> tuple[SimState, SegSnapshot]:
    s, snap = _run_seg_core(stat, dp, _unsqueeze(s0), [int(until)])
    return take_lane(s, 0), take_lane(snap, 0)


def _run_seg_batch(stat: StaticShape, dps: DynParams, s0s: SimState,
                   untils) -> tuple[SimState, SegSnapshot]:
    """Segmented analogue of :func:`_run_batch`: G lanes, one pack, each
    paused at its own boundary (``untils``, G ints or a (G,) tensor)."""
    if torch.is_tensor(untils):
        untils = untils.tolist()
    return _run_seg_core(stat, dps, s0s, untils)


def run_segment(stat: StaticShape, dp: DynParams, state: SimState,
                until) -> tuple[SimState, SegSnapshot]:
    """Advance ``state`` until sim-time reaches ``until`` (or the run ends).

    Returns the resumable state plus an end-of-segment snapshot. A run
    split into N segments with unchanged ``dp`` equals the single-shot
    :func:`run_sim` in every state leaf and metric; the diagnostic
    ``Globals.iters`` can differ only when a fully idle stall window spans
    a boundary (one extra iteration per boundary inside it).
    """
    return _run_seg_dyn(stat, dp, state, until)


def run_sim(cfg: EngineConfig, device=None) -> SimState:
    """Run a simulation to completion and return the final state."""
    stat, dp = split_config(cfg, device=device)
    return _run_dyn(stat, dp, init_state_dyn(stat, dp))


def simulate(protocol: str, workload: WorkloadSpec, n_threads: int,
             costs: CostModel | None = None, horizon: int = 2_000_000,
             p_abort: float = 0.0, drain: bool = False, seed: int = 0,
             attrib: bool = False, device=None, **proto_over) -> SimState:
    """Run one protocol over one workload on ``device`` (default: CUDA)."""
    cfg = EngineConfig(
        protocol=protocol_params(protocol, **proto_over),
        costs=costs or CostModel(),
        workload=workload,
        n_threads=n_threads,
        horizon=horizon,
        p_abort=p_abort,
        drain=drain,
        seed=seed,
        attrib=attrib,
    )
    return run_sim(cfg, device=device)
