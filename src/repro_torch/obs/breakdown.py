"""TickBreakdown helpers: conservation checks and fraction tables.

The engine charges every thread-tick of every iteration to exactly one
``(branch, bin)`` cell of ``Globals.tb`` (see ``engine._TB_PHASE_BIN`` and
DESIGN.md §11), so for any run or segment observed at the padded thread
count T::

    sum(tb) == T * elapsed_ticks

holds *exactly* (both sides are i32 sums of the same per-iteration
``T * dt`` contributions, so the identity survives wraparound mod 2^32 —
irrelevant at test scales, exact at any scale).
"""
from __future__ import annotations

import numpy as np

from ..core.lock.engine import TB_NAMES
from ..core.lock.metrics import _np


def _tb_of(obj):
    """Accept a SimState, a Globals, or a raw (branches, N_TB) array or
    tensor (on any device)."""
    g = getattr(obj, "g", obj)
    tb = getattr(g, "tb", g)
    return _np(tb).astype(np.int64)


def tick_sum(obj) -> int:
    """Total attributed thread-ticks of a state/Globals/tb array."""
    return int(_tb_of(obj).sum())


def check_conservation(obj, n_threads: int, elapsed: int | None = None):
    """Assert sum(breakdown) == n_threads * elapsed_ticks.

    ``n_threads`` must be the PADDED thread count (padded HALT threads
    accrue idle ticks — they are real simulated thread-time). ``elapsed``
    defaults to ``g.now`` (whole run); pass a window length for segments.
    Returns the common value so callers can report it.
    """
    g = getattr(obj, "g", obj)
    if elapsed is None:
        elapsed = int(g.now)
    got = tick_sum(obj)
    want = int(n_threads) * int(elapsed)
    if got != want:
        raise AssertionError(
            f"tick-conservation violated: sum(breakdown)={got} != "
            f"T*elapsed={n_threads}*{elapsed}={want} (diff {got - want})")
    return got


def fractions(bd: dict) -> dict:
    """{bin: ticks} -> {bin: fraction of total}; empty-safe."""
    total = sum(bd.values())
    if total <= 0:
        return {k: 0.0 for k in bd}
    return {k: v / total for k, v in bd.items()}


def breakdown_row(bd: dict, prec: int = 3) -> str:
    """One 'k=v;k=v' fragment of bin fractions for benchmark rows."""
    fr = fractions(bd)
    return ";".join(f"{k}={fr.get(k, 0.0):.{prec}f}" for k in TB_NAMES)
