"""Lock-event tracing inside the engine's loop (PyTorch).

The port of ``repro.obs.trace``. The step already computes every transition
mask (grants, waits, timeouts, deadlock victims, early releases, group
joins, commits, completed rollbacks); ``engine._make_step_events`` names
them (:class:`repro_torch.core.lock.engine.StepEvents`) and :func:`_record`
appends them to a fixed-allocation buffer on the engine's device each
iteration, with the reference's event ids and order:

* The *allocation* is a shape; the usable capacity ``cap`` is a 0-d device
  tensor and ``on`` a host switch. ``on=False`` records nothing, so the run
  equals the untraced one leaf for leaf.
* A full buffer drops, never wraps: once ``n`` reaches ``cap`` further
  events add to ``dropped`` and leave the stored prefix untouched.
* Events are appended in simulated-time order: within an iteration the
  start-of-interval blocks (``t_pre``) come first, threads ascending, and
  ``t_post`` of one iteration is ``t_pre`` of the next.

What differs from the reference is the execution. The buffer holds one slot
more than its allocation: the last slot is a sink that every dropped event
is scattered into (the reference's ``mode="drop"``), so recording is a
cumsum and one scatter with no host sync; ``n``, ``dropped`` and ``cap`` stay
on the device. Traced runs are single-lane, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.lock import engine
from ..core.lock.costs import CostModel, protocol_params
from ..core.lock.engine import (DynParams, EngineConfig, I32, NOTK,
                                SegSnapshot, SimState, StaticShape,
                                StepEvents, init_state_dyn, split_config)
from ..core.lock.workload import WorkloadSpec
from ..device import resolve

# event ids: indices into EVENTS, the reference's (traces are artifacts)
EVENTS = ("grant", "wait_enter", "timeout", "deadlock_victim",
          "early_release", "group_join", "commit", "abort")
(EV_GRANT, EV_WAIT_ENTER, EV_TIMEOUT, EV_VICTIM, EV_RELEASE, EV_GROUP_JOIN,
 EV_COMMIT, EV_ABORT) = range(len(EVENTS))

# the blocks of one iteration in buffer order: (mask field, at t_post, row
# field or None for thread-level events, event id)
_BLOCKS = (
    ("timeout", False, "row_cur", EV_TIMEOUT),
    ("victim", False, "row_cur", EV_VICTIM),
    ("grant", False, "row_cur", EV_GRANT),
    ("group_join", False, "row_cur", EV_GROUP_JOIN),
    ("release", True, "row_cur", EV_RELEASE),
    ("commit", True, None, EV_COMMIT),
    ("abort", True, None, EV_ABORT),
    ("wait_enter", True, "row_begin", EV_WAIT_ENTER),
)
_N_PRE = sum(1 for b in _BLOCKS if not b[1])


class TraceBuf(NamedTuple):
    """Fixed-allocation event buffer. The four columns hold ``alloc + 1``
    slots, the last a sink for dropped events; ``n``/``dropped``/``cap``
    are 0-d i32 tensors on the buffer's device and ``on`` a host bool."""
    ts: torch.Tensor       # (A + 1,) i32 tick of the event
    tid: torch.Tensor      # (A + 1,) i32 thread id
    row: torch.Tensor      # (A + 1,) i32 row id (NOTK: thread-level event)
    ev: torch.Tensor       # (A + 1,) i32 event id (index into EVENTS)
    n: torch.Tensor        # ()   i32 events stored
    dropped: torch.Tensor  # ()   i32 events dropped at capacity
    cap: torch.Tensor      # ()   i32 usable capacity (<= A)
    on: bool               # master switch


def make_trace(cap: int = 4096, alloc: int | None = None, on: bool = True,
               device=None) -> TraceBuf:
    """Fresh buffer on ``device`` (default: CUDA) holding ``alloc``
    (default ``cap``) events, of which ``cap`` are usable."""
    dev = resolve(device)
    A = int(alloc if alloc is not None else cap)

    def col():
        return torch.full((A + 1,), NOTK, dtype=I32, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=I32, device=dev)

    return TraceBuf(ts=col(), tid=col(), row=col(), ev=col(),
                    n=scalar(0), dropped=scalar(0),
                    cap=scalar(min(int(cap), A)), on=bool(on))


class _Recorder:
    """Appends a single-lane pack's :class:`StepEvents` to a copy of a
    :class:`TraceBuf` (the caller's buffer is never written)."""

    def __init__(self, tbuf: TraceBuf, T: int):
        dev = tbuf.ts.device
        self.sink = tbuf.ts.shape[0] - 1
        # columns ts, tid, row, ev stacked: one scatter appends all four
        self.store = torch.stack([tbuf.ts, tbuf.tid, tbuf.row, tbuf.ev])
        self.n, self.dropped, self.cap = tbuf.n, tbuf.dropped, tbuf.cap
        self.on = tbuf.on
        nb = len(_BLOCKS)
        self.tid = torch.arange(T, dtype=I32, device=dev).repeat(nb)
        self.ev = torch.tensor([b[3] for b in _BLOCKS], dtype=I32,
                               device=dev).repeat_interleave(T)
        self.no_row = torch.full((T,), NOTK, dtype=I32, device=dev)
        self.T = T

    def __call__(self, se: StepEvents) -> None:
        """:func:`_record` on the recorder's state, in place."""
        if self.on:
            self.store, self.n, self.dropped = _record(
                self.store, self.n, self.dropped, self.cap, self.sink,
                self.tid, self.ev, self.no_row, se)

    def buf(self) -> TraceBuf:
        ts, tid, row, ev = self.store
        return TraceBuf(ts=ts, tid=tid, row=row, ev=ev, n=self.n,
                        dropped=self.dropped, cap=self.cap, on=self.on)


def _record(store, n, dropped, cap, sink: int, tid, evid, no_row,
            se: StepEvents):
    """Append one iteration's events of lane 0 (device, no host sync).

    A cumsum packs the fired events densely after ``n``; positions at or
    past ``cap`` go to the sink slot and count as dropped. ``store`` (the
    (4, A + 1) stacked columns) is written in place and returned with the
    new counters."""
    T = no_row.shape[0]
    m = torch.cat([getattr(se, b[0])[0] for b in _BLOCKS])
    ts = torch.cat([se.t_pre[:1].expand(_N_PRE * T),
                    se.t_post[:1].expand((len(_BLOCKS) - _N_PRE) * T)])
    row = torch.cat([no_row if b[2] is None else getattr(se, b[2])[0]
                     for b in _BLOCKS])
    csum = torch.cumsum(m, 0, dtype=I32)
    pos = csum + (n - 1)
    ok = m & (pos < cap)
    slot = torch.where(ok, pos, sink).long()
    store.scatter_(1, slot.expand(4, -1), torch.stack([ts, tid, row, evid]))
    stored = ok.sum(dtype=I32)
    return store, n + stored, dropped + (csum[-1] - stored)


def run_traced(stat: StaticShape, dp: DynParams, state: SimState,
               tbuf: TraceBuf, until=None
               ) -> tuple[SimState, TraceBuf, SegSnapshot]:
    """Advance one config's ``state`` with event tracing until sim-time
    reaches ``until`` (or the run ends); resumable like ``run_segment``.

    Same step, same loop condition as the untraced entry points (the loop
    reads its condition on the host once per iteration, as
    ``engine._loop`` does); the state never depends on the buffer, so the
    run equals the untraced one leaf for leaf with ``on`` either way.
    Returns the state, a new buffer and the end-of-run snapshot."""
    lp = engine._lanes(dp)
    u = None if until is None else engine._lane_value(
        np.asarray([until], np.int64), I32, lp.dev, 1)
    step_ev = engine._make_step_events(stat, lp, until=u)
    rec = _Recorder(tbuf, stat.n_threads)

    def body(s):
        s2, ev = step_ev(s)
        rec(ev)
        return s2

    s = engine._loop(engine._make_cond(lp, u), body,
                     engine._unsqueeze(state))
    snap = engine._snapshot(stat, s)
    return engine.take_lane(s, 0), rec.buf(), engine.take_lane(snap, 0)


def simulate_traced(protocol: str, workload: WorkloadSpec, n_threads: int,
                    costs: CostModel | None = None,
                    horizon: int = 2_000_000, p_abort: float = 0.0,
                    drain: bool = False, seed: int = 0, cap: int = 4096,
                    alloc: int | None = None, trace_on: bool = True,
                    attrib: bool = False, device=None,
                    **proto_over) -> tuple[SimState, TraceBuf]:
    """Traced twin of :func:`repro_torch.core.lock.simulate` on ``device``
    (default: CUDA)."""
    cfg = EngineConfig(
        protocol=protocol_params(protocol, **proto_over),
        costs=costs or CostModel(), workload=workload,
        n_threads=n_threads, horizon=horizon, p_abort=p_abort,
        drain=drain, seed=seed, attrib=attrib)
    stat, dp = split_config(cfg, device=device)
    tb0 = make_trace(cap, alloc=alloc, on=trace_on,
                     device=dp.txn_cap.device)
    s, tb, _ = run_traced(stat, dp, init_state_dyn(stat, dp), tb0)
    return s, tb


def events_host(tbuf: TraceBuf) -> dict:
    """The stored prefix on the host: numpy columns plus counters."""
    n = int(tbuf.n)

    def col(t):
        return t[:n].cpu().numpy()

    return {"ts": col(tbuf.ts), "tid": col(tbuf.tid), "row": col(tbuf.row),
            "ev": col(tbuf.ev), "n": n, "dropped": int(tbuf.dropped),
            "cap": int(tbuf.cap)}
