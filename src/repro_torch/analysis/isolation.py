"""Serializability certifier over lock-engine event traces.

The port of ``repro.analysis.isolation``: host Python over the event
columns, a copy of the reference's; only the traced run of
:func:`certify_run` is the port's engine. Consumes a
:class:`repro_torch.obs.trace.TraceBuf` (or its ``events_host`` dict)
and certifies, per run, that the schedule the engine actually
executed is conflict-serializable and honors each protocol's locking
discipline — the paper's §6.5 claim ("all six protocols produce
serializable schedules") checked on real schedules rather than asserted
from the design.

**Why this works without a read log**: in this engine only writes take
tickets (``need_ticket = begin & bwr``; reads are snapshot reads off the
committed-value array and never enqueue), so every ``grant`` /
``group_join`` event is a *write* acquisition and the conflict graph is
the write-write graph. Snapshot reads cannot create rw/wr anomalies
against in-flight writers because they read only committed state.

**Derivation** (:func:`dependency_graph`):

* The buffer position ``seq`` is the authoritative order: the buffer is
  appended time-ordered by construction, and within one iteration the
  blocks land t_pre-first with tids ascending, which resolves dt=0 ticks
  and same-iteration group co-grants deterministically.
* Per thread, events partition into *attempts* at ``commit`` / ``abort``
  terminators (``timeout`` and ``deadlock_victim`` are decisions — the
  attempt ends only when the rollback completes, i.e. at ``abort``).
* Per row, the committed attempts' acquisitions in ``seq`` order form a
  chain; consecutive distinct attempts give a ww edge. Consecutive
  pairs generate the same reachability as all pairs (the per-row order
  is total), so cycle detection over them is exact.
* An edge is ``ww-uncommitted`` when the successor acquired before the
  predecessor's commit landed — only possible under early release /
  group locking / per-op release, and forbidden for the strict-2PL
  protocols.

**Per-protocol certification mode**: protocols that hold write locks to
commit (or cascade dependents on abort) must produce an acyclic
txn-level ww graph — that is what ``serializable`` certifies for mysql /
o1 / o2 / group / bamboo. Brook-2PL is different *by design*: transaction
chopping releases each row at its last use, so txn-level ww cycles are
expected (two chopped txns can touch shared rows in opposite ticket
order) and benign — the engine's writes are commutative counter
increments, and chopping theory + commutativity is the protocol's
serializability argument, not 2PL. For ``per_op_release`` protocols the
certifier therefore proves the *chopped* execution serializable at piece
granularity: every per-row hold interval is mutually exclusive (checked,
not assumed), all conflict edges then follow the global piece order
(acyclic by construction), acquisition is ascending-rank, and no dirty
windows exist. Txn-level ww cycles are still counted and reported
(``chop_ww_cycles``) as the documented, expected signature of chopping.
* A *dirty edge* is a committed successor acquiring a row inside an
  aborted predecessor's (acquire, abort] window — it may have built on
  state that was then reverted. The engine's commit-order discipline +
  cascading aborts claim this never happens; the certifier proves it on
  the trace (exercised with injected ``p_abort`` in tests).

**Caveats**: a trace with ``dropped > 0`` yields a *lower-bound*
certificate (the checked prefix is certified; the tail is unobserved) —
``Certificate.lower_bound`` says so. Malformed buffers (out-of-range
event ids, time-travel timestamps, counters off) are rejected before
any certification (``input-invalid`` violations).
"""
from __future__ import annotations

import dataclasses

from ..core.lock.costs import CostModel, ProtocolParams, protocol_params
from ..core.lock.engine import EngineConfig, split_config
from ..obs.trace import (EV_ABORT, EV_COMMIT, EV_GRANT, EV_GROUP_JOIN,
                         EV_RELEASE, EV_TIMEOUT, EV_VICTIM, EV_WAIT_ENTER,
                         EVENTS, TraceBuf, events_host, simulate_traced)

_ACQUIRE = (EV_GRANT, EV_GROUP_JOIN)
_TERMINAL = (EV_COMMIT, EV_ABORT)


def _as_events(trace_or_events) -> dict:
    if isinstance(trace_or_events, TraceBuf):
        return events_host(trace_or_events)
    return trace_or_events


@dataclasses.dataclass
class Attempt:
    """One transaction attempt: a thread's events up to a terminator."""
    tid: int
    idx: int                      # per-thread attempt ordinal
    terminator: str               # "commit" | "abort" | "open"
    end_seq: int = -1             # seq of the terminator event
    end_ts: int = -1
    # acquisitions in seq order: (seq, ts, row, ev)
    acquires: list = dataclasses.field(default_factory=list)
    # (seq, ts, row) lists
    releases: list = dataclasses.field(default_factory=list)
    wait_enters: list = dataclasses.field(default_factory=list)
    timeouts: int = 0
    victims: int = 0

    @property
    def key(self) -> tuple:
        return (self.tid, self.idx)


@dataclasses.dataclass(frozen=True)
class Edge:
    pred: tuple                   # Attempt.key
    succ: tuple
    row: int
    kind: str                     # "ww" | "ww-uncommitted"


@dataclasses.dataclass
class Certificate:
    protocol: str
    mode: str                     # "txn-ww" | "chop-piece"
    serializable: bool
    n_attempts: int
    n_committed: int
    n_aborted: int
    n_open: int
    n_edges: int
    cycle: list | None            # attempt keys forming a cycle, if any
    chop_ww_cycles: bool          # chop mode: txn-level ww cycle exists
                                  # (expected + benign; informational)
    dirty_edges: list             # (aborted_key, committed_key, row)
    violations: list              # human-readable rule violations
    lower_bound: bool             # True when the trace dropped events

    @property
    def ok(self) -> bool:
        return self.serializable and not self.dirty_edges \
            and not self.violations

    def text(self) -> str:
        head = (f"{self.protocol} [{self.mode}]: "
                f"attempts={self.n_attempts} "
                f"(committed={self.n_committed} aborted={self.n_aborted} "
                f"open={self.n_open}) ww_edges={self.n_edges}")
        lines = [head]
        if self.mode == "chop-piece" and self.chop_ww_cycles:
            lines.append("  note: txn-level ww cycles present — expected "
                         "under chopping; serializability holds at piece "
                         "granularity + commutative writes")
        if self.lower_bound:
            lines.append("  NOTE: trace dropped events — certificate "
                         "covers the stored prefix only (lower bound)")
        if self.cycle:
            lines.append(f"  CYCLE: {' -> '.join(map(str, self.cycle))}")
        for p, s, row in self.dirty_edges[:10]:
            lines.append(f"  DIRTY: committed {s} acquired row {row} "
                         f"inside aborted {p}'s abort window")
        lines.extend(f"  VIOLATION: {v}" for v in self.violations[:10])
        lines.append("  " + ("CERTIFIED conflict-serializable"
                             if self.ok else "REJECTED"))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# input validation — a certifier that trusts a corrupt buffer certifies
# nothing, so malformed traces are rejected up front (negative-tested).
# ---------------------------------------------------------------------------

def validate_events(ev: dict) -> list:
    problems = []
    n = int(ev["n"])
    if n < 0 or n > len(ev["ts"]):
        return [f"input-invalid: n={n} outside stored arrays"]
    if int(ev.get("dropped", 0)) < 0:
        problems.append("input-invalid: negative dropped counter")
    last_ts = None
    for i in range(n):
        e = int(ev["ev"][i])
        t = int(ev["ts"][i])
        if not 0 <= e < len(EVENTS):
            problems.append(f"input-invalid: event id {e} at seq {i} "
                            f"outside EVENTS")
            break
        if t < 0:
            problems.append(f"input-invalid: negative tick {t} at seq {i}")
            break
        if last_ts is not None and t < last_ts:
            problems.append(f"input-invalid: time travel at seq {i} "
                            f"({last_ts} -> {t}); buffer must be "
                            f"time-ordered")
            break
        last_ts = t
    return problems


# ---------------------------------------------------------------------------
# attempts + graph
# ---------------------------------------------------------------------------

def attempts_from_events(ev: dict) -> list:
    """Partition the buffer into per-thread attempts (see module doc)."""
    cur: dict = {}
    done: list = []

    def _get(tid: int) -> Attempt:
        if tid not in cur:
            n_prev = sum(1 for a in done if a.tid == tid)
            cur[tid] = Attempt(tid=tid, idx=n_prev, terminator="open")
        return cur[tid]

    counts: dict = {}
    for i in range(int(ev["n"])):
        tid, row, e, t = (int(ev["tid"][i]), int(ev["row"][i]),
                          int(ev["ev"][i]), int(ev["ts"][i]))
        a = _get(tid)
        if e in _ACQUIRE:
            a.acquires.append((i, t, row, e))
        elif e == EV_RELEASE:
            a.releases.append((i, t, row))
        elif e == EV_WAIT_ENTER:
            a.wait_enters.append((i, t, row))
        elif e == EV_TIMEOUT:
            a.timeouts += 1
        elif e == EV_VICTIM:
            a.victims += 1
        elif e in _TERMINAL:
            a.terminator = EVENTS[e]
            a.end_seq, a.end_ts = i, t
            done.append(a)
            counts[tid] = counts.get(tid, 0) + 1
            del cur[tid]
    done.extend(cur.values())     # still-open attempts at capture end
    return done


def dependency_graph(attempts: list) -> tuple:
    """(nodes, edges, dirty) over committed attempts; see module doc."""
    committed = {a.key: a for a in attempts if a.terminator == "commit"}
    aborted = [a for a in attempts if a.terminator == "abort"]

    # per-row acquisition chains, committed attempts only, in seq order
    chains: dict = {}
    for a in attempts:
        if a.terminator != "commit":
            continue
        for seq, ts, row, _e in a.acquires:
            chains.setdefault(row, []).append((seq, ts, a))
    edges: list = []
    for row, chain in chains.items():
        chain.sort()
        for (ps, _pt, pa), (ss, _st, sa) in zip(chain, chain[1:]):
            if pa.key == sa.key:
                continue
            kind = "ww-uncommitted" if ss < pa.end_seq else "ww"
            edges.append(Edge(pred=pa.key, succ=sa.key, row=row,
                              kind=kind))

    # dirty edges: committed attempt acquired a row inside an aborted
    # attempt's (acquire, abort] seq window
    dirty: list = []
    for p in aborted:
        for pseq, _pt, row, _e in p.acquires:
            for a in committed.values():
                for sseq, _st, srow, _se in a.acquires:
                    if srow == row and pseq < sseq <= p.end_seq:
                        dirty.append((p.key, a.key, row))
    return committed, edges, dirty


def find_cycle(nodes: dict, edges: list):
    """Kahn's algorithm; on leftovers, walk successors to extract one
    concrete cycle for the report. Returns None when acyclic."""
    adj: dict = {k: [] for k in nodes}
    indeg = {k: 0 for k in nodes}
    for e in edges:
        if e.pred in adj and e.succ in indeg:
            adj[e.pred].append(e.succ)
            indeg[e.succ] += 1
    queue = [k for k, d in indeg.items() if d == 0]
    seen = 0
    while queue:
        k = queue.pop()
        seen += 1
        for s in adj[k]:
            indeg[s] -= 1
            if indeg[s] == 0:
                queue.append(s)
    if seen == len(nodes):
        return None
    # Leftovers are the nodes on or downstream of cycles; every leftover
    # has a leftover PREDECESSOR (not necessarily a successor), so walk
    # the reversed graph and flip the found loop back into edge order.
    rest = {k for k, d in indeg.items() if d > 0}
    radj: dict = {k: [] for k in rest}
    for e in edges:
        if e.pred in rest and e.succ in rest:
            radj[e.succ].append(e.pred)
    start = min(rest)
    path, where = [start], {start: 0}
    while True:
        nxt = next(p for p in radj[path[-1]] if p in rest)
        if nxt in where:
            loop = path[where[nxt]:] + [nxt]
            return loop[::-1]
        where[nxt] = len(path)
        path.append(nxt)


# ---------------------------------------------------------------------------
# protocol-discipline checks
# ---------------------------------------------------------------------------

def _strict_2pl_violations(attempts: list, edges: list,
                           committed: dict) -> list:
    """Strict 2PL: locks hold to commit. No early-release events may
    fire, and every ww successor acquires at-or-after the predecessor's
    commit tick (equality allowed: t_post of iteration k IS t_pre of
    iteration k+1)."""
    out = []
    n_rel = sum(len(a.releases) for a in attempts)
    if n_rel:
        out.append(f"strict-2pl: {n_rel} early_release event(s) under a "
                   f"hold-to-commit protocol")
    for e in edges:
        if e.kind == "ww-uncommitted":
            out.append(f"strict-2pl: {e.succ} acquired row {e.row} "
                       f"before {e.pred} committed")
            continue
        pred = committed[e.pred]
        succ = committed[e.succ]
        ts = next(t for _s, t, r, _e in succ.acquires if r == e.row)
        if ts < pred.end_ts:
            out.append(f"strict-2pl: {e.succ} acquired row {e.row} at "
                       f"tick {ts} < {e.pred} commit tick {pred.end_ts}")
    return out


def _hold_violations(attempts: list) -> list:
    """Piece-level mutual exclusion: per row, a holder's interval
    [grant seq, release-or-terminator seq] never overlaps the next
    holder's grant. This is the checked premise that makes the chopped
    execution's conflict edges follow the global piece order (and hence
    the piece graph acyclic). Open attempts without a release contribute
    only their grant (their end is unobserved)."""
    per_row: dict = {}
    for a in attempts:
        rel_by_row: dict = {}
        for seq, _t, row in a.releases:
            rel_by_row.setdefault(row, []).append(seq)
        for gseq, _t, row, _e in a.acquires:
            rels = [s for s in rel_by_row.get(row, []) if s > gseq]
            end = min(rels) if rels else \
                (a.end_seq if a.terminator != "open" else None)
            per_row.setdefault(row, []).append((gseq, end, a.key))
    out = []
    for row, holds in per_row.items():
        holds.sort()
        for (g1, e1, k1), (g2, _e2, k2) in zip(holds, holds[1:]):
            if e1 is not None and g2 < e1:
                out.append(f"mutual-exclusion: row {row} granted to "
                           f"{k2} at seq {g2} while {k1} held it until "
                           f"seq {e1}")
    return out


def _rank_violations(attempts: list, acq_rank) -> list:
    """Brook-2PL: rows are requested in non-decreasing chop rank within
    an attempt (checked on wait_enter order, which is request order)."""
    out = []
    ranks = list(acq_rank)
    for a in attempts:
        reqs = sorted(a.wait_enters)
        rs = [int(ranks[row]) for _s, _t, row in reqs
              if 0 <= row < len(ranks)]
        bad = [i for i in range(1, len(rs)) if rs[i] < rs[i - 1]]
        if bad:
            out.append(f"brook-rank: attempt {a.key} requested ranks "
                       f"{rs} — descends at position {bad[0]}")
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def certify(trace_or_events, protocol: str | ProtocolParams,
            acq_rank=None) -> Certificate:
    """Certify one run's schedule. ``protocol`` picks the discipline
    checks (a name from PROTOCOLS or explicit params); ``acq_rank`` is
    the chop-rank table (DynWorkload.acq_rank) for ordered-acquire
    protocols."""
    ev = _as_events(trace_or_events)
    pp = (protocol if isinstance(protocol, ProtocolParams)
          else protocol_params(protocol))
    mode = "chop-piece" if pp.per_op_release else "txn-ww"
    problems = validate_events(ev)
    if problems:
        return Certificate(
            protocol=pp.name, mode=mode, serializable=False,
            n_attempts=0, n_committed=0, n_aborted=0, n_open=0,
            n_edges=0, cycle=None, chop_ww_cycles=False, dirty_edges=[],
            violations=problems, lower_bound=bool(ev.get("dropped", 0)))
    attempts = attempts_from_events(ev)
    committed, edges, dirty = dependency_graph(attempts)
    cycle = find_cycle(committed, edges)
    violations = []
    strict = not (pp.early_release or pp.early_all or pp.per_op_release
                  or pp.group_lock)
    if strict:
        violations += _strict_2pl_violations(attempts, edges, committed)
    if pp.ordered_acquire and acq_rank is not None:
        violations += _rank_violations(attempts, acq_rank)
    if mode == "chop-piece":
        # txn-level cycles are the expected chopping signature; the
        # certified claim is piece-level (see module doc)
        violations += _hold_violations(attempts)
        serializable = not any(v.startswith("mutual-exclusion")
                               for v in violations)
        chop_cycles, cycle = cycle is not None, None
    else:
        serializable = cycle is None
        chop_cycles = False
    return Certificate(
        protocol=pp.name, mode=mode, serializable=serializable,
        n_attempts=len(attempts),
        n_committed=len(committed),
        n_aborted=sum(1 for a in attempts if a.terminator == "abort"),
        n_open=sum(1 for a in attempts if a.terminator == "open"),
        n_edges=len(edges), cycle=cycle, chop_ww_cycles=chop_cycles,
        dirty_edges=dirty, violations=violations,
        lower_bound=bool(ev.get("dropped", 0)))


def certify_run(protocol: str, workload, n_threads: int,
                horizon: int = 40_000, p_abort: float = 0.0,
                seed: int = 0, cap: int = 65_536, device=None,
                **proto_over) -> Certificate:
    """Run the traced engine on ``device`` (default: CUDA) and certify the
    resulting schedule."""
    _s, tb = simulate_traced(protocol, workload, n_threads,
                             horizon=horizon, p_abort=p_abort, seed=seed,
                             cap=cap, device=device, **proto_over)
    cfg = EngineConfig(protocol=protocol_params(protocol, **proto_over),
                       costs=CostModel(), workload=workload,
                       n_threads=n_threads, horizon=horizon,
                       p_abort=p_abort, seed=seed)
    _stat, dp = split_config(cfg, device=device)
    rank = dp.wl.acq_rank if protocol_params(protocol).ordered_acquire \
        else None
    return certify(tb, protocol_params(protocol, **proto_over),
                   acq_rank=None if rank is None else rank.tolist())


def total_trace_wait_ticks(trace_or_events, enders=(EV_GRANT, EV_TIMEOUT,
                                                    EV_VICTIM)) -> int:
    """Sum of resolved wait spans (wait_enter -> grant/timeout/victim)
    across all threads. Unresolved waits and dropped events only shrink
    the sum, so this is a sound lower bound on engine lock-wait ticks
    (property-tested against the TickBreakdown lock_wait bin)."""
    ev = _as_events(trace_or_events)
    open_by_tid: dict = {}
    total = 0
    for i in range(int(ev["n"])):
        tid, e, t = int(ev["tid"][i]), int(ev["ev"][i]), int(ev["ts"][i])
        if e == EV_WAIT_ENTER:
            open_by_tid[tid] = t
        elif e in enders and tid in open_by_tid:
            total += t - open_by_tid.pop(tid)
    return total
