"""Hotspot ranking from the per-record contention accumulator.

Consumes ``Globals.ca`` — the engine's on-device (N_CA, R) per-record
accumulator (DESIGN.md §14) — and turns it into the paper's hotspot
story: which records concentrate the waiting, how skewed the observed
contention is versus the workload's zipf ground truth, and which rows
the queue-length threshold rule (``core.hotspot``) would promote.

Conservation: the ``CA_WAIT`` lane charges exactly the ticks that charge
the TickBreakdown's ``lock_wait`` bin (cold+hot), so
:func:`check_ca_conservation` asserts the two totals equal — the
per-record twin of ``breakdown.check_conservation``, valid per run and
per governed segment (``delta_globals`` windows).
"""
from __future__ import annotations

import numpy as np

import torch

from ..core.hotspot import DEFAULT_THRESHOLD, detect_hot_queue
from ..core.lock.chop import zipf_weights
from ..core.lock.engine import (CA_GRANTS, CA_NAMES, CA_QMAX, CA_TIMEOUTS,
                                CA_VICTIMS, CA_WAIT, TB_LOCKWAIT)
from ..core.lock.metrics import _np, hotspot_rows


def _ca_of(obj) -> np.ndarray:
    """Accept a SimState, a Globals, or a raw (N_CA, R) array or tensor
    (on any device)."""
    g = getattr(obj, "g", obj)
    ca = getattr(g, "ca", g)
    return _np(ca).astype(np.int64)


def _hot_rule(ca: np.ndarray, threshold: int) -> np.ndarray:
    """The queue-threshold promote rule on each row's peak queue depth."""
    return detect_hot_queue(torch.from_numpy(ca[CA_QMAX]),
                            threshold).numpy()


def check_ca_conservation(obj) -> int:
    """Assert sum of per-record wait ticks == TickBreakdown lock_wait.

    Both sides accumulate the identical per-iteration ``phase==WAIT``
    contributions (per row vs per branch-bin), so the identity is exact
    in i32. Accepts a SimState or Globals — including a
    ``delta_globals`` window, which makes it the per-governed-segment
    check too. Returns the common value. Attribution-off states pass
    only if lock_wait is also zero; check only attribution-on runs.
    """
    g = getattr(obj, "g", obj)
    got = int(_ca_of(g)[CA_WAIT].sum())
    want = int(_np(g.tb).astype(np.int64)[:, TB_LOCKWAIT].sum())
    if got != want:
        raise AssertionError(
            f"contention-conservation violated: sum(ca[wait])={got} != "
            f"tb[lock_wait]={want} (diff {got - want})")
    return got


def wait_share(obj) -> np.ndarray:
    """(R,) share of all lock-wait ticks charged to each record."""
    wait = _ca_of(obj)[CA_WAIT].astype(np.float64)
    total = wait.sum()
    return wait / total if total > 0 else wait


def gini(x) -> float:
    """Gini coefficient of a nonnegative vector (0 uniform, ->1 skewed)."""
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = x.size
    total = x.sum()
    if n == 0 or total <= 0:
        return 0.0
    cum = np.cumsum(x)
    return float((n + 1 - 2.0 * cum.sum() / total) / n)


def top_share(obj, k: int = 1) -> float:
    """Share of all lock-wait ticks on the k most-waited records."""
    s = np.sort(wait_share(obj))[::-1]
    return float(s[:k].sum())


def hotspot_summary(obj, spec=None,
                    threshold: int = DEFAULT_THRESHOLD) -> dict:
    """Scalar hotspot metrics of a run (or delta window).

    ``spec`` (a WorkloadSpec) adds the ground-truth comparison: the Gini
    of the workload's zipf access weights over the same key space — how
    much of the observed contention skew is the workload's own skew and
    how much the protocol's amplification (lock waits concentrate harder
    than accesses under strict 2PL; group/brook flatten back toward it).
    """
    ca = _ca_of(obj)
    share = wait_share(ca)
    n_hot = int(_hot_rule(ca, threshold).sum())
    out = {
        "wait_ticks": int(ca[CA_WAIT].sum()),
        "grants": int(ca[CA_GRANTS].sum()),
        "timeouts": int(ca[CA_TIMEOUTS].sum()),
        "victims": int(ca[CA_VICTIMS].sum()),
        "rows_waited": int((ca[CA_WAIT] > 0).sum()),
        "top1_share": float(np.sort(share)[::-1][:1].sum()),
        "top10_share": float(np.sort(share)[::-1][:10].sum()),
        "gini_wait": gini(ca[CA_WAIT]),
        "max_queue": int(ca[CA_QMAX].max()),
        "n_hot_rule": n_hot,
    }
    if spec is not None and getattr(spec, "kind", None) == "zipf":
        w = zipf_weights(spec.n_rows, spec.zipf_s)
        out["gini_zipf"] = gini(w)
        out["skew_amplification"] = (
            out["gini_wait"] / out["gini_zipf"] if out["gini_zipf"] else 0.0)
    return out


def hotspot_report(obj, spec=None, top_k: int = 10,
                   threshold: int = DEFAULT_THRESHOLD) -> str:
    """Text hotspot ranking: the contention accumulator made readable.

    Top-K records by wait ticks with their full accumulator lanes and
    wait share, the threshold rule's verdict per row, and the summary
    scalars (incl. the zipf ground-truth Gini when ``spec`` is given).
    """
    ca = _ca_of(obj)
    summ = hotspot_summary(ca, spec=spec, threshold=threshold)
    hot = _hot_rule(ca, threshold)
    share = wait_share(ca)
    lines = [
        f"# hotspot report: {summ['rows_waited']} records waited on, "
        f"{summ['wait_ticks']} wait ticks, "
        f"top-1 share {summ['top1_share']:.3f}, "
        f"gini {summ['gini_wait']:.3f}"
        + (f" (zipf ground truth {summ['gini_zipf']:.3f}, "
           f"amplification {summ['skew_amplification']:.2f}x)"
           if "gini_zipf" in summ else ""),
        f"# threshold rule (> {threshold} queued): "
        f"{summ['n_hot_rule']} rows promoted, "
        f"max observed queue {summ['max_queue']}",
        "row," + ",".join(CA_NAMES) + ",wait_share,hot",
    ]
    for r in hotspot_rows(ca, top_k):
        row = r["row"]
        cells = ",".join(str(r[k]) for k in CA_NAMES)
        lines.append(f"{row},{cells},{share[row]:.3f},"
                     f"{int(hot[row])}")
    return "\n".join(lines)


def hotspot_lane_events(trace_or_events, top_k: int = 4,
                        end: int | None = None) -> list:
    """Perfetto counter-track events for the hottest rows' queue depths.

    Derives each row's queue-depth timeline from the event stream (+1 at
    wait_enter, -1 when the wait resolves) and emits Chrome trace
    counter events ("ph":"C", one track per hot row, pid 1) for the
    ``top_k`` rows by queued ticks — the hotspot lanes of the trace
    export (consumed by ``export.to_chrome_trace``).
    """
    from .export import _as_events, _wait_spans
    ev = _as_events(trace_or_events)
    spans = list(_wait_spans(ev, end=end))
    qticks: dict = {}
    for _tid, row, t0, t1, _e in spans:
        qticks[row] = qticks.get(row, 0) + (t1 - t0)
    top = [r for r, _ in
           sorted(qticks.items(), key=lambda kv: -kv[1])[:top_k]]
    out = []
    for rank, row in enumerate(top):
        deltas: dict = {}
        for _tid, r, t0, t1, _e in spans:
            if r != row:
                continue
            deltas[t0] = deltas.get(t0, 0) + 1
            deltas[t1] = deltas.get(t1, 0) - 1
        depth = 0
        out.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": rank, "args": {"name": f"hotspot row {row}"}})
        for t in sorted(deltas):
            depth += deltas[t]
            out.append({"ph": "C", "name": f"qlen row {row}", "pid": 1,
                        "tid": rank, "ts": t / 10.0,
                        "args": {"queued": depth}})
    return out
