"""Discrete-time concurrency-control engine in PyTorch (single lane).

The port of ``repro.core.lock.engine``: T database worker threads run
transactions over R rows under one of six locking protocols (MySQL-2PL, O1,
O2 queue locking, TXSQL group locking, Bamboo, Brook-2PL), tick-accurately,
with all state in tensors. The modelling is the reference's (ticket queues
per row, per-row aggregates re-derived every iteration from the per-thread
ticket table, commit order = update order, counter-valued rows) and every
``SimState`` leaf equals the reference's ``_run_dyn`` bit for bit; see the
reference module's docstring for the model itself.

What differs is the execution, not the semantics:

* One lane. Protocol flags, costs and workload values are host scalars in
  :class:`DynParams`, so every ``lax.cond`` of the reference becomes a host
  ``if`` and a disabled branch is not computed at all.
* The loop is a host ``while`` whose condition reads one device bool per
  iteration (the reference's ``_make_cond``).
* Segment reductions are ``scatter_reduce`` into buffers pre-filled with the
  int32 extremes, which is what ``jax.ops.segment_min/max`` leave in rows no
  slot touches (not the engine's ``INF``). Reductions that share an index
  are stacked into one scatter over an (n*R,) buffer.
* JAX gathers clamp out-of-range indices and ``mode="drop"`` scatters drop
  them; torch does neither, so key indices are clamped for gathers and
  masked for scatters. Generated keys always lie in [0, R), so both guards
  are the identity on every state the engine reaches.
* ``_hist_bucket`` (``jnp.log`` in the reference) is an integer threshold
  table, computed at import by emulating the reference's f32 arithmetic in
  float64, so no device ``log`` decides a bucket edge.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ...device import resolve
from .costs import CostModel, ProtocolParams, protocol_params
from .workload import (WorkloadSpec, DynWorkload, dyn_workload, gen_txn_dyn,
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
N_QHIST = 12

# per-record contention attribution: ca[CA_WAIT].sum() ==
# tb[:, TB_LOCKWAIT].sum() (i32, exact mod 2**32).
N_CA = 6
CA_WAIT, CA_GRANTS, CA_TIMEOUTS, CA_VICTIMS, CA_QSUM, CA_QMAX = range(N_CA)
CA_NAMES = ("wait_ticks", "grants", "timeouts", "victims",
            "queue_sum", "queue_max")


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

    Scalars are host values (floats rounded to f32, as the reference holds
    them), so the step branches on protocol flags on the host.
    ``txn_cap`` is a (T,) i32 tensor on the engine's device.
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


def split_config(cfg: EngineConfig, device=None
                 ) -> tuple[StaticShape, DynParams]:
    """EngineConfig -> (shapes, per-config params on ``device``)."""
    dev = resolve(device)
    p, c, w = cfg.protocol, cfg.costs, cfg.workload
    T, L = cfg.n_threads, w.txn_len
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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class _Keys(NamedTuple):
    """A key-index tensor prepared once for the gathers and scatters that
    use it: clamped (JAX gather semantics) and in-range mask (drop)."""
    idx: torch.Tensor        # long, clamped to [0, R)
    ok: torch.Tensor         # bool, raw key in [0, R)


def _keys(k: torch.Tensor, R: int) -> _Keys:
    k = k.reshape(-1)
    return _Keys(k.clamp(0, R - 1).long(), (k >= 0) & (k < R))


def _seg_min(datas, valids, k: _Keys, R: int) -> torch.Tensor:
    """Stacked ``_seg_min``: row i of the (n, R) result is the reference's
    ``segment_min(where(valids[i], datas[i], INF), keys)``."""
    vals = torch.cat([
        torch.where(k.ok, torch.where(v.reshape(-1), d.reshape(-1), INF),
                    IMAX) for d, v in zip(datas, valids)])
    idx = torch.cat([k.idx + i * R for i in range(len(datas))])
    out = torch.full((len(datas) * R,), IMAX, dtype=I32, device=idx.device)
    return out.scatter_reduce_(0, idx, vals, "amin").view(len(datas), R)


def _seg_max(data, valid, k: _Keys, R: int) -> torch.Tensor:
    vals = torch.where(k.ok, torch.where(valid.reshape(-1), data.reshape(-1),
                                         -1), IMIN)
    out = torch.full((R,), IMIN, dtype=I32, device=vals.device)
    return out.scatter_reduce_(0, k.idx, vals, "amax")


def _seg_count(valids, k: _Keys, R: int) -> torch.Tensor:
    """Stacked ``_seg_sum`` of ones: (n, R) i32 counts of valid slots."""
    vals = torch.cat([(v.reshape(-1) & k.ok).to(I32) for v in valids])
    idx = torch.cat([k.idx + i * R for i in range(len(valids))])
    out = torch.zeros((len(valids) * R,), dtype=I32, device=idx.device)
    return out.scatter_add_(0, idx, vals).view(len(valids), R)


def _isum(x: torch.Tensor) -> torch.Tensor:
    """Sum to a 0-dim i32, wrapping like the reference's i32 sums."""
    return x.sum().to(I32)


def _hist_bucket(lat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Latency-histogram bucket: the count of thresholds <= lat (clipped)."""
    return torch.searchsorted(thr, lat.contiguous(), right=True).clamp(
        max=N_HIST - 1)


def _stop_time(dp: DynParams) -> int:
    """Drain gets enough wall-clock past the horizon for timeouts to fire
    and cascades to unwind (livelocks then surface as drain failures)."""
    if dp.drain:
        t = dp.horizon + 3 * max(dp.wait_timeout, dp.horizon)
        assert t < 2**31, "drain stop time overflows i32"
        return t
    return dp.horizon


class Derived(NamedTuple):
    us: torch.Tensor          # (R,) next grantable ticket
    cc: torch.Tensor          # (R,) commit cursor
    top: torch.Tensor         # (R,) highest applied ticket
    holder: torch.Tensor      # (R,) thread holding lowest live ticket
    n_wait: torch.Tensor      # (R,) unapplied live tickets (queue length)
    n_live: torch.Tensor      # (R,) all live tickets
    hotof: torch.Tensor       # (T,) row of first early applied op (-1)
    napp: torch.Tensor        # (T,) applied op count per thread


def _derive(stat: StaticShape, dp: DynParams, th: Threads, rows: Rows,
            kf: _Keys | None = None) -> Derived:
    R = stat.n_rows
    T, L = th.keys.shape
    kf = _keys(th.keys, R) if kf is None else kf
    live = th.ticket >= 0
    blocking = live & (~th.applied | ~th.early)
    appl = live & th.applied
    cc_block = appl & ~th.released
    if dp.group_commit:
        cc_block = cc_block & ~th.committing
    tid = torch.arange(T, dtype=I32, device=th.keys.device)[:, None]
    enc = th.ticket * T + tid
    us, cc, hmin = _seg_min((th.ticket, th.ticket, enc),
                            (blocking, cc_block, live), kf, R)
    us = torch.where(us == INF, rows.nt, us)
    cc = torch.where(cc == INF, us, cc)
    top = _seg_max(th.ticket, appl & ~th.committing, kf, R)
    holder = torch.where(hmin == INF, NOTK, hmin % T)
    n_wait, n_live = _seg_count((live & ~th.applied, live), kf, R)

    ea = appl & th.early
    first = torch.argmax(ea.to(I32), dim=1)       # first True (0 if none)
    hotof = torch.where(ea.any(dim=1),
                        th.keys.gather(1, first[:, None]).squeeze(1), NOTK)
    napp = appl.sum(dim=1).to(I32)
    return Derived(us, cc, top, holder, n_wait, n_live, hotof, napp)


# ---------------------------------------------------------------------------
# engine step
# ---------------------------------------------------------------------------

def _make_step(stat: StaticShape, dp: DynParams):
    """Build the tick step for one config. Stage numbers and line-by-line
    semantics follow ``repro.core.lock.engine._make_step_events``; branches
    whose protocol flag is off are skipped on the host."""
    T, R, L = stat.n_threads, stat.n_rows, stat.txn_len
    dev = dp.txn_cap.device
    tids = torch.arange(T, dtype=I32, device=dev)
    tb_bin = torch.from_numpy(_TB_PHASE_BIN).to(dev)
    hist_thr = torch.from_numpy(HIST_THRESHOLDS).to(dev)
    stop_time = _stop_time(dp)
    ca_rows = torch.arange(4, device=dev).repeat_interleave(T) * R
    zero_t = torch.zeros((T,), dtype=I32, device=dev)
    false_t = torch.zeros((T,), dtype=torch.bool, device=dev)
    if dp.arrival_rate > 0:
        interval = max(int(np.float32(dp.n_active)
                           / np.float32(dp.arrival_rate)), 1)

    def cur(field_tl, opc):
        """Per-thread value at its current op slot (``opc`` clipped)."""
        return field_tl.gather(1, opc).squeeze(1)

    def scat_add(target, k: _Keys, val):
        """``target.at[k].add(val, mode="drop")`` (out of place)."""
        return target.scatter_add(0, k.idx, torch.where(k.ok, val, 0))

    def step(s: SimState) -> SimState:
        th, rows, g = s
        kf = _keys(th.keys, R)
        d = _derive(stat, dp, th, rows, kf)
        now = g.now

        opc = th.op.clamp(0, L - 1).long()[:, None]
        cur_key = cur(th.keys, opc)
        ck = _keys(cur_key, R)
        cur_tkt = cur(th.ticket, opc)
        in_wait = th.phase == WAIT

        # ------------------------------------------------ 1. mark aborts
        forced = th.forced
        # 1a. wait timeout (wait_timeout <= 0 disables both timeouts)
        if dp.wait_timeout > 0:
            waited = now - th.wstart
            to_fire = ((in_wait & (waited >= dp.wait_timeout))
                       | ((th.phase == CWAIT)
                          & (waited >= dp.commit_wait_timeout)))
            forced = forced | to_fire
        else:
            to_fire = false_t
        # 1b. deadlock detection (waits-for cycle walk, up to 8 hops); one
        # victim per cycle: its max thread id.
        holder_at = d.holder[ck.idx]
        if dp.has_detection:
            succ = torch.where(in_wait, holder_at, NOTK)
            succ = torch.where(succ == tids, NOTK, succ)
            walk = succ
            mx = tids
            on_cycle = false_t
            is_wait = th.phase == WAIT
            for _ in range(8):
                ok = walk >= 0
                wi = torch.where(ok, walk, 0).long()
                mx = torch.maximum(mx, torch.where(ok, walk, -1))
                on_cycle = on_cycle | (ok & (walk == tids))
                walk = torch.where(ok & is_wait[wi], succ[wi], NOTK)
            victim = on_cycle & (tids == mx)
            forced = forced | victim
        else:
            victim = false_t
        # 1c. proactive hot+non-hot rollback (§4.5)
        if dp.proactive_abort:
            hrow = d.hotof
            hold = holder_at
            hold_ok = hold >= 0
            hold_i = torch.where(hold_ok, hold, 0).long()
            pro = (in_wait & (hrow >= 0) & hold_ok
                   & ~rows.hot[ck.idx]
                   & (d.hotof[hold_i] == hrow) & (hold != tids))
            forced = forced | pro
        # 1d. cascade propagation: any applied early ticket >= casc[key]
        casc_at = rows.casc[kf.idx].view(T, L)
        ae = th.applied & th.early & (th.ticket >= 0)
        forced = forced | (ae & (th.ticket >= casc_at)).any(dim=1)
        # threads that cannot abort anymore (committing) stay
        forced = forced & (th.phase != COMMIT) & (th.phase != HALT)
        casc_min = _seg_min((th.ticket,), (ae & forced[:, None],), kf, R)[0]
        casc = torch.minimum(rows.casc, casc_min)
        casc = torch.where((casc < INF) & (d.top < casc), INF, casc)

        # ------------------------------------------------ 2. divert to RBWAIT
        parkable = forced & ((th.phase == WAIT) | (th.phase == CWAIT))
        phase = torch.where(parkable, RBWAIT, th.phase)
        wstart = torch.where(parkable, now, th.wstart)

        # ------------------------------------------------ 4. grants
        # 4a. WAIT -> EXEC
        kw = ck.idx
        hot_w = rows.hot[kw]
        grantable = ((phase == WAIT) & ~forced & (cur_tkt == d.us[kw])
                     & ~rows.updating[kw] & (casc[kw] == INF))
        if dp.group_lock:
            open_leader = rows.gleader[kw]
            is_leader_grant = grantable & hot_w & (open_leader == NOTK)
            is_member_grant = grantable & hot_w & (open_leader != NOTK)
        else:
            is_leader_grant = is_member_grant = false_t

        if dp.has_detection:
            qlen = d.n_wait[kw].to(F32)
            dd = (qlen * dp.dd_coeff).to(I32)
        else:
            dd = zero_t
        hotq = hot_w if dp.hot_queue else false_t
        if dp.group_lock:
            hot_cost = torch.where(is_leader_grant, dp.lock_base,
                                   dp.grant_cost).to(I32)
        else:
            hot_cost = dp.lock_base
        overhead = torch.where(hotq, hot_cost, dd + dp.lock_base)
        work = torch.where(grantable, overhead + dp.op_exec, th.work)
        phase = torch.where(grantable, EXEC, phase)
        detleft = torch.where(grantable, torch.where(hotq, 0, dd),
                              th.detleft)
        g = g._replace(
            wait_ticks=g.wait_ticks + _isum(
                torch.where(grantable, now - wstart, 0)).to(F32),
            lock_ops=g.lock_ops + _isum(
                grantable & (~hotq | is_leader_grant)),
            dd_ticks=g.dd_ticks + _isum(
                torch.where(grantable & ~hotq, dd, 0)))
        upd_new = scat_add(torch.zeros((R,), dtype=I32, device=dev), ck,
                           grantable.to(I32)) > 0
        updating = rows.updating | upd_new

        gl, gc = rows.gleader, rows.gcount
        if dp.group_lock:
            gl = gl.scatter_reduce(
                0, kw, torch.where(ck.ok & is_leader_grant, cur_tkt, NOTK),
                "amax")
            gc = scat_add(gc, ck, (is_leader_grant | is_member_grant)
                          .to(I32))
            close_q = gc >= dp.batch_size
            if dp.dynamic_batch:
                close_q = close_q | ((d.n_wait == 0) & ~upd_new)
            close = (gl != NOTK) & close_q
            gl = torch.where(close, NOTK, gl)
            gc = torch.where(close, 0, gc)

        # 4b. CWAIT -> COMMIT (commit order on early rows; leader hold)
        is_cw = (phase == CWAIT) & ~forced
        live = th.ticket >= 0
        lae = live & th.applied & th.early
        cc_at = d.cc[kf.idx].view(T, L)
        order_ok = (~(lae & ~th.released) | (cc_at == th.ticket)).all(dim=1)
        no_casc = (~live | (casc[kf.idx].view(T, L) == INF)).all(dim=1)
        can_commit = is_cw & order_ok & no_casc
        if dp.group_lock:
            lead_open = (lae & (gl[kf.idx].view(T, L) == th.ticket)).any(
                dim=1)
            can_commit = can_commit & ~lead_open
        vol = can_commit & th.willab
        can_commit = can_commit & ~th.willab

        base_cost = dp.commit_base + dp.sync_lat
        batch_end, batch_n = rows.batch_end, rows.batch_n
        if dp.group_commit and dp.sync_lat > 0:
            h_ok = d.hotof >= 0
            hk = _keys(torch.where(h_ok, d.hotof, 0), R)
            be = batch_end[hk.idx]
            join = can_commit & h_ok & (be > now)
            fresh = can_commit & h_ok & ~join
            cost = torch.where(join, (be - now) + dp.commit_base, base_cost)
            batch_end = batch_end.scatter_reduce(
                0, hk.idx, torch.where(hk.ok & fresh, now + dp.sync_lat, 0),
                "amax")
            batch_n = scat_add(batch_n, hk, (can_commit & h_ok).to(I32))
        else:
            cost = base_cost
        phase = torch.where(can_commit, COMMIT,
                            torch.where(vol, RBWAIT, phase))
        work = torch.where(can_commit, cost, work)
        wstart = torch.where(vol, now, wstart)
        committing = th.committing | (can_commit[:, None] & th.applied)
        forced = forced | vol
        vabort = th.vabort | vol

        # ------------------------------------------------ 4c. RBWAIT->RBACK
        top_at = d.top[kf.idx].view(T, L)
        my_turn = (~ae | (top_at == th.ticket)).all(dim=1)
        my_turn = my_turn | ((now - wstart) >= dp.rb_turn_timeout)
        start_rb = (phase == RBWAIT) & my_turn
        phase = torch.where(start_rb, RBACK, phase)
        work = torch.where(start_rb, d.napp * dp.rb_per_op + dp.rb_base,
                           work)

        # ------------------------------------------------ 5. dt & advance
        paying = ((phase == EXEC) | (phase == COMMIT) | (phase == RBACK)
                  | (phase == BACKOFF) | (phase == ARRIVE))
        dt_pay = torch.where(paying, work, INF).min()
        rb_exp = torch.where(phase == RBWAIT,
                             wstart + dp.rb_turn_timeout - now, INF).min()
        texp = torch.clamp(rb_exp, min=1)
        if dp.wait_timeout > 0:
            texp = torch.minimum(texp, torch.where(
                in_wait | (phase == CWAIT),
                wstart + dp.wait_timeout - now, INF).min())
        dt = torch.minimum(dt_pay, torch.clamp(texp, min=1))
        dt = torch.where((phase == START).any(), 0, dt)   # starts are instant
        dt = torch.minimum(torch.clamp(dt, min=0),
                           torch.clamp(stop_time - now, min=1))
        now = now + dt
        work = torch.where(paying, work - dt, work)
        n_busy = _isum((phase == EXEC) | (phase == COMMIT)
                       | (phase == RBACK)).to(F32)
        g = g._replace(now=now, iters=g.iters + 1,
                       busy_ticks=g.busy_ticks + n_busy * dt.to(F32))

        # tick attribution: dt to exactly one (branch, bin) per thread; EXEC
        # pays its pending detection ticks first.
        is_ex = phase == EXEC
        ddpay = torch.where(is_ex, torch.minimum(detleft, dt), 0)
        detleft = detleft - ddpay
        engaged = ((phase == WAIT) | is_ex | (phase == CWAIT)
                   | (phase == COMMIT))
        branch = (engaged & rows.hot[ck.idx]).to(I32) * N_TB
        tb = g.tb.reshape(-1).scatter_add(
            0, torch.cat([branch + tb_bin[phase.long()],
                          branch + TB_DETECT]).long(),
            torch.cat([torch.where(is_ex, dt - ddpay, dt), ddpay]))
        g = g._replace(tb=tb.view(g.tb.shape))
        if dp.attrib:
            vals = torch.cat([
                torch.where(phase == WAIT, dt, 0), grantable.to(I32),
                (to_fire & in_wait).to(I32), victim.to(I32)])
            ok4 = ck.ok.repeat(4)
            ca = g.ca.reshape(-1).scatter_add(
                0, ca_rows + ck.idx.repeat(4),
                torch.where(ok4, vals, 0)).view(N_CA, R)
            ca = torch.cat([ca[:CA_QSUM],
                            (ca[CA_QSUM] + d.n_wait * dt)[None],
                            torch.maximum(ca[CA_QMAX], d.n_wait)[None]])
            g = g._replace(ca=ca)

        done = paying & (work <= 0)

        # ------------------------------------------------ 6. completions
        # 6a. EXEC done: apply the write, advance op
        e_done = done & (phase == EXEC)
        eff_wr = cur(th.iswr, opc) & e_done & ~cur(th.dup, opc)
        eff_i = eff_wr.to(I32)
        applied_val = scat_add(rows.applied_val, ck, eff_i)
        updating = updating & ~(scat_add(
            torch.zeros((R,), dtype=I32, device=dev), ck, eff_i) > 0)
        applied = th.applied.scatter(
            1, opc, (eff_wr | cur(th.applied, opc))[:, None])
        # freeze the release semantics in force when the write applied
        if dp.early_all:
            early_now = torch.ones_like(eff_wr)
        elif dp.early_release:
            early_now = rows.hot[ck.idx]
        else:
            early_now = false_t
        early = th.early.scatter(
            1, opc, torch.where(eff_wr, early_now, cur(th.early, opc))
            [:, None])
        released = th.released
        if dp.per_op_release:
            # Brook-2PL per-op release at the key's last use (chop.py)
            rel_now = e_done & cur(th.lastu, opc) & ~forced & ~th.willab
            rel_slot = ((th.keys == cur_key[:, None]) & (th.ticket >= 0)
                        & rel_now[:, None])
            released = released | rel_slot
            early = early | (rel_slot & applied)
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
        committed_val = scat_add(
            rows.committed_val, kf,
            (rel & applied & c_done[:, None]).reshape(-1).to(I32))
        lat = now - th.tstart
        g = g._replace(
            commits=g.commits + _isum(c_done),
            lat_sum=g.lat_sum + _isum(torch.where(c_done, lat, 0)).to(F32),
            hist=g.hist.scatter_add(0, _hist_bucket(lat, hist_thr),
                                    c_done.to(I32)))

        # 6c. RBACK done: revert applied writes, release tickets
        r_done = done & (phase == RBACK)
        applied_val = scat_add(
            applied_val, kf,
            -(rel & applied & r_done[:, None]).reshape(-1).to(I32))
        g = g._replace(
            user_aborts=g.user_aborts + _isum(r_done & vabort),
            forced_aborts=g.forced_aborts + _isum(r_done & ~vabort))
        keep = ~(c_done | r_done)[:, None]
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
        work = torch.where(r_done, jitter * dp.backoff, work)
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
        past = (now >= dp.horizon) | (txn >= dp.txn_cap)
        phase = torch.where(st & past, HALT, phase)
        st = st & ~past
        if dp.arrival_rate > 0:
            # fixed-TPS open loop
            arr = txn * interval + (tids * 977) % interval
            early_t = st & (arr > now)
            phase = torch.where(early_t, ARRIVE, phase)
            work = torch.where(early_t, arr - now, work)
            st = st & ~early_t
        keys_n, iswr_n, dup_n, lastu_n, nops_n = gen_txn_dyn(
            stat.kind, R, L, dp.wl, tids, txn,
            acq_order=dp.ordered_acquire)
        if dp.p_abort > 0:
            wab = will_abort_dyn(dp.wl.seed, dp.p_abort, tids, txn)
            willab = torch.where(st, wab, th.willab)
        else:
            willab = th.willab & ~st
        sel = st[:, None]
        keys = torch.where(sel, keys_n, th.keys)
        iswr = torch.where(sel, iswr_n, th.iswr)
        dup = torch.where(sel, dup_n, th.dup)
        lastu = torch.where(sel, lastu_n, th.lastu)
        nops = torch.where(st, nops_n, th.nops)
        tstart = torch.where(st & ~retry, now, th.tstart)
        op = torch.where(st, 0, op)

        # ------------------------------------------------ 8. begin next op
        begin = st | next_op
        opc = op.clamp(0, L - 1).long()[:, None]
        bkey = cur(keys, opc)
        bk = _keys(bkey, R)
        b_iswr = cur(iswr, opc)
        bwr = b_iswr & ~cur(dup, opc)
        need_ticket = begin & bwr
        direct = begin & ~bwr
        phase = torch.where(direct, EXEC, phase)
        work = torch.where(direct, torch.where(b_iswr, dp.op_exec,
                                               dp.read_exec).to(I32), work)
        detleft = torch.where(direct, 0, detleft)

        # FIFO ticket assignment with same-tick ranking (sort by key); the
        # sentinel key R sorts non-takers after every real key. enc is
        # unique, so the order is deterministic.
        enc = torch.where(need_ticket, bkey, R) * T + tids
        order = torch.argsort(enc)
        sk = bkey[order]
        sm = need_ticket[order]
        same = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                          (sk[1:] == sk[:-1]) & sm[1:] & sm[:-1]])
        idx = torch.arange(T, dtype=I32, device=dev)
        seg_start = torch.cummax(torch.where(same, 0, idx), dim=0).values
        rank = torch.empty_like(idx).scatter_(0, order, idx - seg_start)
        tkt = torch.where(need_ticket, rows.nt[bk.idx] + rank, NOTK)
        nt = scat_add(rows.nt, bk, need_ticket.to(I32))
        ticket = ticket.scatter(
            1, opc, torch.where(need_ticket, tkt, cur(ticket, opc))[:, None])
        phase = torch.where(need_ticket, WAIT, phase)
        wstart = torch.where(need_ticket, now, wstart)

        # ------------------------------------------------ 9. hotspot detect
        hot = rows.hot
        if dp.hot_queue:
            live3 = ticket >= 0
            d3_nwait, d3_nlive = _seg_count((live3 & ~applied, live3),
                                            _keys(keys, R), R)
            demote = hot & (d3_nlive == 0)
            hot = (hot | (d3_nwait > dp.hot_threshold)) & ~demote
            gl = torch.where(demote, NOTK, gl)
            gc = torch.where(demote, 0, gc)

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
        return SimState(th, rows, g)

    return step


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def init_state_dyn(stat: StaticShape, dp: DynParams) -> SimState:
    """Initial state on ``dp``'s device; padded threads start in HALT."""
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


def _make_cond(dp: DynParams):
    """The reference's loop condition, read on the host (one device sync
    per iteration)."""
    stop_time = _stop_time(dp)

    def cond(s: SimState) -> bool:
        if dp.drain:
            running = (s.th.phase != HALT).any() & (s.g.now < stop_time)
        else:
            running = s.g.now < dp.horizon
        return bool(running & (s.g.iters < dp.max_iters))

    return cond


def _run_core(stat: StaticShape, dp: DynParams, s0: SimState) -> SimState:
    """Step ``s0`` until the loop condition fails (``lax.while_loop``)."""
    step = _make_step(stat, dp)
    cond = _make_cond(dp)
    s = s0
    while cond(s):
        s = step(s)
    return s


def _run_dyn(stat: StaticShape, dp: DynParams, s0: SimState) -> SimState:
    return _run_core(stat, dp, s0)


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
