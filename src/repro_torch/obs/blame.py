"""Blocker blame attribution from TraceBuf events (DESIGN.md §14).

Answers the question the per-thread wait profile cannot: not just *where*
threads waited but *who made them wait*. Built entirely on the host from
the on-device event buffer (``repro_torch.obs.trace``):

* **Holder intervals** — an ``EV_GRANT`` opens a hold of (thread, row);
  the hold closes at the thread's next ``EV_COMMIT``/``EV_ABORT``
  terminator (strict 2PL releases everything there) or at an
  ``EV_RELEASE`` on that row (brook per-op early release). A thread's
  transaction *attempt* is identified by counting its terminators, so
  blame lands on a specific attempt, not just a thread slot.
* **Blame matrix** — each wait span (``EV_WAIT_ENTER`` paired with the
  ``EV_GRANT``/``EV_TIMEOUT``/``EV_VICTIM`` that resolved it, the same
  pairing as ``export._wait_spans``) is overlapped with the holder
  intervals on its row; the overlap ticks are blamed on the holding
  attempt. Under group locking several members hold a hot row
  concurrently, so the matrix can over-count a span (every concurrent
  holder is blamed in full for the time it contributed to blocking);
  ``per_record`` counts each span once and therefore matches the wait
  profile's queued ticks exactly.
* **Critical path** — the longest blocking chain: a waiter's dominant
  blocker was often itself waiting (on another row) for most of the
  hold; following dominant blockers hop by hop yields the paper's
  convoy picture with per-hop durations. Cycles (deadlocks before
  victimization) are cut at the first repeated thread.

Dropped events make every number a lower bound — reports carry the same
warning header as the wait profile.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from .export import _as_events, _wait_spans
from .trace import EVENTS, EV_ABORT, EV_COMMIT, EV_GRANT, EV_RELEASE


def _holder_intervals(ev: dict, end: int | None = None) -> dict:
    """row -> time-sorted list of (t0, t1, tid, attempt) hold intervals.

    Holds still open at the end of the capture window close at ``end``
    (default: last recorded tick), mirroring ``_wait_spans``.
    """
    attempts: dict = defaultdict(int)
    open_by_tid: dict = defaultdict(dict)        # tid -> {row: t0}
    out: dict = defaultdict(list)
    n = ev["n"]
    tail = int(ev["ts"][n - 1]) if n else 0
    close_t = tail if end is None else int(end)
    for i in range(n):
        t, tid, row, e = (int(ev["ts"][i]), int(ev["tid"][i]),
                          int(ev["row"][i]), int(ev["ev"][i]))
        if e == EV_GRANT:
            open_by_tid[tid][row] = t
        elif e == EV_RELEASE:
            t0 = open_by_tid[tid].pop(row, None)
            if t0 is not None:
                out[row].append((t0, t, tid, attempts[tid]))
        elif e in (EV_COMMIT, EV_ABORT):
            for r0, t0 in open_by_tid.pop(tid, {}).items():
                out[r0].append((t0, t, tid, attempts[tid]))
            attempts[tid] += 1
    for tid, rows in open_by_tid.items():
        for r0, t0 in rows.items():
            out[r0].append((t0, max(close_t, t0), tid, attempts[tid]))
    for row in out:
        out[row].sort()
    return dict(out)


@dataclasses.dataclass
class BlameResult:
    """Blame attribution over one trace capture.

    ``matrix`` maps a blocking attempt ``(tid, attempt)`` to
    ``{row: blame_ticks}``; ``per_txn`` and ``per_record`` are its two
    marginals, except ``per_record`` counts every wait span once (no
    concurrent-holder over-count) so it equals the wait profile's queued
    ticks per row. ``unattributed`` is wait time with no recorded holder
    overlapping (holder's grant predates the capture, or events were
    dropped).
    """
    matrix: dict
    per_txn: dict
    per_record: dict
    unattributed: dict
    total_wait: int
    n_spans: int
    dropped: int

    def top_blockers(self, k: int = 10) -> list:
        """[(tid, attempt), blame_ticks] heaviest blocking attempts."""
        return sorted(self.per_txn.items(), key=lambda kv: -kv[1])[:k]

    def top_records(self, k: int = 10) -> list:
        return sorted(self.per_record.items(), key=lambda kv: -kv[1])[:k]


def blame_matrix(trace_or_events, end: int | None = None) -> BlameResult:
    """Attribute every wait span's ticks to the attempts holding its row."""
    ev = _as_events(trace_or_events)
    holders = _holder_intervals(ev, end=end)
    matrix: dict = defaultdict(lambda: defaultdict(int))
    per_txn: dict = defaultdict(int)
    per_record: dict = defaultdict(int)
    unattributed: dict = defaultdict(int)
    total = n_spans = 0
    for tid, row, t0, t1, _e in _wait_spans(ev, end=end):
        n_spans += 1
        total += t1 - t0
        per_record[row] += t1 - t0
        covered = 0
        for h0, h1, htid, hatt in holders.get(row, ()):
            if h0 >= t1:
                break
            if htid == tid:
                continue
            ov = min(t1, h1) - max(t0, h0)
            if ov > 0:
                matrix[(htid, hatt)][row] += ov
                per_txn[(htid, hatt)] += ov
                covered = max(covered, min(t1, h1))
        # conservative uncovered estimate: ticks past the furthest
        # overlapping holder end (0 when fully covered)
        reach = max(covered, t0)
        if reach < t1:
            unattributed[row] += t1 - reach
    return BlameResult(
        matrix={k: dict(v) for k, v in matrix.items()},
        per_txn=dict(per_txn), per_record=dict(per_record),
        unattributed=dict(unattributed), total_wait=total,
        n_spans=n_spans, dropped=int(ev["dropped"]))


def critical_path(trace_or_events, end: int | None = None,
                  max_hops: int = 64) -> list:
    """The longest blocking chain, as hop dicts (waiter -> blocker -> ...).

    Each wait span's *dominant* blocker is the attempt with the largest
    overlap on its row; if that blocker has a wait span of its own
    overlapping the same window, the chain continues there. The returned
    list starts at the chain head (the longest total blocked time) with
    per-hop ``{"tid", "row", "t0", "t1", "dur", "blocker"}``; cycles
    (deadlocks before victimization) are cut at the first repeat.
    """
    ev = _as_events(trace_or_events)
    holders = _holder_intervals(ev, end=end)
    spans = list(_wait_spans(ev, end=end))
    by_tid: dict = defaultdict(list)
    for i, (tid, _row, t0, t1, _e) in enumerate(spans):
        by_tid[tid].append(i)

    def dominant_blocker(i):
        tid, row, t0, t1, _e = spans[i]
        best, best_ov = None, 0
        for h0, h1, htid, hatt in holders.get(row, ()):
            if h0 >= t1:
                break
            if htid == tid:
                continue
            ov = min(t1, h1) - max(t0, h0)
            if ov > best_ov:
                best, best_ov = (htid, hatt), ov
        return best

    def next_span(i, blocker_tid):
        """The blocker's own wait span with max overlap of span i."""
        _tid, _row, t0, t1, _e = spans[i]
        best, best_ov = None, 0
        for j in by_tid.get(blocker_tid, ()):
            jt0, jt1 = spans[j][2], spans[j][3]
            ov = min(t1, jt1) - max(t0, jt0)
            if ov > best_ov:
                best, best_ov = j, ov
        return best

    memo: dict = {}

    def chain(i, seen):
        if i in memo:
            return memo[i]
        tid, row, t0, t1, _e = spans[i]
        hop = {"tid": tid, "row": row, "t0": t0, "t1": t1, "dur": t1 - t0,
               "blocker": None}
        rest: list = []
        b = dominant_blocker(i)
        if b is not None:
            hop["blocker"] = b
            j = next_span(i, b[0])
            if (j is not None and spans[j][0] not in seen
                    and len(seen) < max_hops):
                rest = chain(j, seen | {spans[j][0]})
        out = [hop] + rest
        memo[i] = out
        return out

    best: list = []
    best_dur = -1
    for i in range(len(spans)):
        c = chain(i, {spans[i][0]})
        dur = sum(h["dur"] for h in c)
        if dur > best_dur:
            best, best_dur = c, dur
    return best


def blame_table(trace_or_events, top_k: int = 10,
                end: int | None = None) -> str:
    """Per-record blame table (text), the companion of ``wait_profile``.

    One line per contended record: its queued ticks (identical to the
    wait profile's number), the share attributed to recorded holders,
    and the single heaviest blocking attempt with its blame share.
    """
    b = blame_matrix(trace_or_events, end=end)
    lines = []
    if b.dropped:
        lines.append(f"# WARNING: {b.dropped} events dropped — blame is "
                     f"a lower bound")
    lines.append(f"# blame table: {len(b.per_record)} contended rows, "
                 f"{b.n_spans} wait spans, {b.total_wait} queued ticks")
    lines.append("row,queued_ticks,attributed_frac,top_blocker,"
                 "top_blocker_ticks")
    # row -> heaviest (attempt, ticks)
    heaviest: dict = {}
    for txn, rows in b.matrix.items():
        for row, ticks in rows.items():
            if ticks > heaviest.get(row, (None, 0))[1]:
                heaviest[row] = (txn, ticks)
    for row, ticks in b.top_records(top_k):
        attr = 1.0 - b.unattributed.get(row, 0) / ticks if ticks else 0.0
        txn, bt = heaviest.get(row, (None, 0))
        who = f"t{txn[0]}#{txn[1]}" if txn else "-"
        lines.append(f"{row},{ticks},{attr:.2f},{who},{bt}")
    chain = critical_path(trace_or_events, end=end)
    if chain:
        hops = " -> ".join(
            f"t{h['tid']}@r{h['row']}({h['dur']}t)" for h in chain[:8])
        lines.append(f"# critical path ({len(chain)} hops, "
                     f"{sum(h['dur'] for h in chain)} blocked ticks): "
                     + hops)
    return "\n".join(lines)
