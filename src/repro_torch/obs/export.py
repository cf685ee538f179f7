"""Trace export: Chrome trace-event JSON (Perfetto) + text wait profiles.

``to_chrome_trace`` emits the Trace Event Format that chrome://tracing and
https://ui.perfetto.dev load directly: each engine thread is a track,
lock waits are duration ("ph":"X") spans from wait_enter to the event
that resolved them (grant / timeout / deadlock_victim), and commits,
victims, releases and group joins are instants. Timestamps convert ticks
to microseconds (1 tick = 0.1us).

``wait_profile`` aggregates the same wait spans per row into the paper's
attribution story: the top-K hottest rows by queued ticks, with how each
wait ended. ``breakdown_table`` renders TickBreakdown fractions for a set
of protocols side by side.
"""
from __future__ import annotations

import json

from ..core.lock.engine import TB_NAMES
from .breakdown import fractions
from .trace import (EVENTS, EV_ABORT, EV_GRANT, EV_WAIT_ENTER, EV_TIMEOUT,
                    EV_VICTIM, EV_RELEASE, EV_GROUP_JOIN, EV_COMMIT,
                    TraceBuf, events_host)


def _as_events(trace_or_events) -> dict:
    if isinstance(trace_or_events, TraceBuf):
        return events_host(trace_or_events)
    return trace_or_events


_WAIT_END = (EV_GRANT, EV_TIMEOUT, EV_VICTIM)


def _wait_spans(ev: dict, end: int | None = None):
    """Pair wait_enter with the event that resolved it, per thread.

    Yields (tid, row, t0, t1, end_ev). The buffer is time-ordered and a
    thread has at most one wait open at a time, so a single forward scan
    suffices. Waits still open at the end of the capture window close at
    ``end`` (default: last recorded tick) with end_ev None.
    """
    open_by_tid: dict = {}
    for i in range(ev["n"]):
        t, tid, row, e = (int(ev["ts"][i]), int(ev["tid"][i]),
                          int(ev["row"][i]), int(ev["ev"][i]))
        if e == EV_WAIT_ENTER:
            open_by_tid[tid] = (row, t)
        elif e in _WAIT_END and tid in open_by_tid:
            row0, t0 = open_by_tid.pop(tid)
            yield tid, row0, t0, t, e
    if open_by_tid:
        tail = int(ev["ts"][ev["n"] - 1]) if ev["n"] else 0
        close = tail if end is None else int(end)
        for tid, (row0, t0) in sorted(open_by_tid.items()):
            yield tid, row0, t0, max(close, t0), None


def to_chrome_trace(trace_or_events, label: str = "lock-engine",
                    end: int | None = None,
                    hotspot_lanes: int = 0) -> dict:
    """Chrome trace-event JSON document (dict; json.dump it yourself or
    use :func:`dump_chrome_trace`). Valid for Perfetto / chrome://tracing.

    ``hotspot_lanes`` > 0 adds one counter track ("ph":"C", pid 1) per
    hottest row showing its wait-queue depth over time — the per-record
    contention picture beside the per-thread spans (DESIGN.md §14).
    """
    ev = _as_events(trace_or_events)
    us = lambda ticks: ticks / 10.0
    out = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": label}}]
    for tid in sorted({int(t) for t in ev["tid"]}):
        out.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": f"worker-{tid}"}})
    for tid, row, t0, t1, e in _wait_spans(ev, end=end):
        out.append({
            "ph": "X", "name": f"wait row {row}", "cat": "lock_wait",
            "pid": 0, "tid": tid, "ts": us(t0), "dur": us(t1 - t0),
            "args": {"row": row,
                     "end": EVENTS[e] if e is not None else "open"}})
    instants = {EV_COMMIT: "commit", EV_VICTIM: "deadlock_victim",
                EV_TIMEOUT: "timeout", EV_RELEASE: "early_release",
                EV_GROUP_JOIN: "group_join", EV_ABORT: "abort"}
    for i in range(ev["n"]):
        e = int(ev["ev"][i])
        if e not in instants:
            continue
        rec = {"ph": "i", "name": instants[e], "cat": "lock_event",
               "pid": 0, "tid": int(ev["tid"][i]),
               "ts": us(int(ev["ts"][i])), "s": "t"}
        if int(ev["row"][i]) >= 0:
            rec["args"] = {"row": int(ev["row"][i])}
        out.append(rec)
    if hotspot_lanes > 0:
        from .hotspot import hotspot_lane_events
        out.extend(hotspot_lane_events(ev, top_k=hotspot_lanes, end=end))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"events_stored": ev["n"], "dropped": ev["dropped"],
                      "capacity": ev["cap"]},
    }


def dump_chrome_trace(path: str, trace_or_events, **kw) -> str:
    doc = to_chrome_trace(trace_or_events, **kw)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


def wait_profile(trace_or_events, top_k: int = 10,
                 end: int | None = None) -> str:
    """Top-K hottest rows by queued ticks (text report).

    One line per row: total queued ticks across all waits on it, wait
    count, and how those waits ended (granted / timed out / victimized /
    still open). A dropped-events warning heads the report when the
    capture truncated — the profile is then a lower bound.
    """
    ev = _as_events(trace_or_events)
    qticks: dict = {}
    ends: dict = {}
    for _tid, row, t0, t1, e in _wait_spans(ev, end=end):
        qticks[row] = qticks.get(row, 0) + (t1 - t0)
        key = EVENTS[e] if e is not None else "open"
        ends.setdefault(row, {})[key] = ends.get(row, {}).get(key, 0) + 1
    lines = []
    if ev["dropped"]:
        lines.append(f"# WARNING: {ev['dropped']} events dropped at "
                     f"capacity {ev['cap']} — profile is a lower bound")
    lines.append(f"# wait profile: {len(qticks)} rows with waits, "
                 f"top {min(top_k, len(qticks))} by queued ticks")
    lines.append("row,queued_ticks,queued_us,waits,grant,timeout,"
                 "deadlock_victim,open")
    ranked = sorted(qticks.items(), key=lambda kv: -kv[1])[:top_k]
    for row, ticks in ranked:
        e = ends.get(row, {})
        waits = sum(e.values())
        lines.append(
            f"{row},{ticks},{ticks / 10.0:.1f},{waits},"
            f"{e.get('grant', 0)},{e.get('timeout', 0)},"
            f"{e.get('deadlock_victim', 0)},{e.get('open', 0)}")
    return "\n".join(lines)


def breakdown_table(results: dict) -> str:
    """Side-by-side TickBreakdown fractions, one line per protocol.

    ``results`` maps a label to a :class:`SimResult` (or any object with a
    ``breakdown`` dict). Fractions of total thread-ticks, so each line
    sums to 1 — the conservation invariant rendered human-readable.
    """
    width = max([len(k) for k in results] + [8])
    head = " ".join(f"{n:>11}" for n in TB_NAMES)
    lines = [f"{'protocol':<{width}} {head}"]
    for name, r in results.items():
        fr = fractions(getattr(r, "breakdown", r))
        cells = " ".join(f"{fr.get(n, 0.0):>11.3f}" for n in TB_NAMES)
        lines.append(f"{name:<{width}} {cells}")
    return "\n".join(lines)
