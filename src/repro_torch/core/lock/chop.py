"""Transaction chopping + SLW-graph lock-order analysis (Brook-2PL).

The static-analysis half of Brook-2PL ("Tolerating High Contention
Workloads with A Deadlock-Free Two-Phase Locking Protocol", Habibi et
al., PAPERS.md): instead of resolving deadlocks *dynamically* (waits-for
walks, timeouts, victim aborts — every prior protocol in ``engine.py``),
Brook-2PL makes them *structurally impossible* by analysing the
transaction templates of a workload ahead of time and emitting

1. a **global lock-acquisition order** — every transaction re-sorts its
   ops so rows are locked in one canonical order.  Along any waits-for
   edge the blocked op's rank is strictly greater than every rank the
   holder still holds (ops before the wait point are all lower-ranked,
   same-rank ops are the same key and therefore re-entrant), so
   waits-for cycles cannot close and no detection machinery is needed;
2. **per-op release points** — the last op touching each row class,
   after which the row's lock can retire (shrinking the 2PL hold
   interval to ``[acquire, last-use]`` instead of ``[acquire, commit]``).

Both artifacts are *data*, not code: the acquisition order ships as a
per-key rank table (``DynWorkload.acq_rank``, an ``(R,)`` i32 array
computed eagerly on the host exactly like the Zipf CDF) and the release
points are evaluated per transaction instance at generation time —
``gen_txn_dyn`` inlines the :func:`last_use` computation so it can share
the dup analysis's pairwise-equality tensor (:func:`last_use` here is
the standalone reference; the tests assert the two agree) — and the
whole protocol rides the existing ``DynParams`` flags
(``ordered_acquire`` / ``per_op_release``).

The analysis pipeline over a :class:`~.workload.WorkloadSpec`:

``row_classes``  — partition the key space into classes with a static
                   per-row *heat* (expected accesses per transaction per
                   row: the contention potential);
``txn_template`` — the per-op-slot (class, writes?) structure;
``slw_graph``    — the static-lock-wait graph: one node per op template,
                   a directed edge u -> v whenever a transaction can
                   *hold* u's lock while *waiting* for v's, weighted by
                   the product of the class heats (how often that hold-
                   while-wait materialises under contention);
``acquisition_order`` — the canonical class order minimising the total
                   SLW edge weight into hot classes: hot rows are
                   acquired **last**, so the span between a hot row's
                   lock point and its release point (its last use — for
                   a hot class ordered last, the very next op) is as
                   short as the chopping allows;
``acquisition_rank``  — the class order flattened to a per-key rank
                   permutation (ties broken by key id, deterministic);
``template_release_points`` — static may-alias release slots per op
                   template (exact per-instance last-use is computed by
                   :func:`last_use` on the generated keys).

``chop()`` bundles everything into a :class:`ChopPlan` for tests, docs,
and the quickstart's human-readable dump.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# sort-key sentinel pushing padded (inactive) op slots after every active
# one; active sort keys are rank * L + slot < 2**28 for every real grid
_PAD_KEY = np.int32(2 ** 29)


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Unnormalized Zipf(s) weights over ranks 1..n (float64).

    THE single definition of the engine's Zipf distribution: the
    workload CDF (``workload.zipf_cdf`` = normalized cumsum, drives key
    generation) and the chop heat model (normalized pmf, drives the
    acquisition rank) both derive from it, so the "hottest keys locked
    last" property can never silently diverge from the keys actually
    drawn.
    """
    ranks = np.arange(1, n + 1, dtype=np.float64)
    return ranks ** (-float(s)) if s > 0 else np.ones_like(ranks)


# ---------------------------------------------------------------------------
# row classes and op templates (static, per workload kind)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowClass:
    """A key-space partition with uniform static contention potential.

    ``heat`` is the expected number of accesses per transaction landing
    on ONE row of the class (class access probability / class size) —
    the quantity the SLW ordering minimises lock hold time for. ``lo``/
    ``hi`` bound the class's key range before any ``hot_base`` rotation.
    """
    name: str
    lo: int
    hi: int
    heat: float

    @property
    def size(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class OpTemplate:
    """One op slot of a transaction template: which class, lock taken?"""
    slot: int
    cls: str
    wr: bool


def row_classes(spec) -> list[RowClass]:
    """Partition ``spec``'s key space into heat-annotated row classes."""
    R, L = spec.n_rows, spec.txn_len
    kind = spec.kind
    if kind == "hotspot_update":
        # op 0 always writes THE hot row; L-1 ops spread over the rest
        return [RowClass("hot", 0, 1, 1.0),
                RowClass("rest", 1, R, (L - 1) / max(R - 1, 1))]
    if kind in ("zipf", "hotspot_mix"):
        # graded-heat class: per-key heat comes from the Zipf pmf (see
        # _key_heat); the class-level heat is the hottest rank's mass
        w = zipf_weights(R, spec.zipf_s)
        return [RowClass("zipf", 0, R, float(L * w[0] / w.sum()))]
    if kind == "hotspot_scan":
        warm = min(max(int(spec.n_hot) * 16, 2), R)
        return [RowClass("warm", 0, warm, L / warm),
                RowClass("cold", warm, R, 0.0)]
    if kind == "uniform":
        return [RowClass("uniform", 0, R, L / R)]
    if kind == "fit":
        nh = min(max(int(spec.n_hot), 1), R)
        return [RowClass("hot_account", 0, nh, 1.0 / nh),
                RowClass("record", nh, R,
                         max(L - 1, 1) / max(R - nh, 1))]
    if kind == "tpcc":
        W = max(int(spec.n_warehouses), 1)
        return [RowClass("warehouse", 0, W, 1.0 / W),
                RowClass("district", W, 11 * W, 1.0 / (10 * W)),
                RowClass("stock", 11 * W, R,
                         max(L - 2, 0) * spec.write_ratio
                         / max(R - 11 * W, 1))]
    raise ValueError(f"chop: unknown workload kind {kind!r}")


def txn_template(spec) -> list[OpTemplate]:
    """The op-slot structure of ``spec``'s transaction template."""
    L, kind = spec.txn_len, spec.kind
    wr = spec.write_ratio > 0 or spec.reads_lock
    if kind == "hotspot_update":
        return [OpTemplate(0, "hot", True)] + [
            OpTemplate(l, "rest", wr) for l in range(1, L)]
    if kind in ("zipf", "hotspot_mix"):
        w = kind == "zipf" or wr
        return [OpTemplate(l, "zipf", w) for l in range(L)]
    if kind == "hotspot_scan":
        return [OpTemplate(l, "warm", True) for l in range(L)]
    if kind == "uniform":
        return [OpTemplate(l, "uniform", wr) for l in range(L)]
    if kind == "fit":
        return ([OpTemplate(0, "hot_account", True)]
                + [OpTemplate(l, "record", l == 1 or wr)
                   for l in range(1, L)])
    if kind == "tpcc":
        return ([OpTemplate(0, "warehouse", True),
                 OpTemplate(1, "district", True)][:L]
                + [OpTemplate(l, "stock", wr) for l in range(2, L)])
    raise ValueError(f"chop: unknown workload kind {kind!r}")


# ---------------------------------------------------------------------------
# SLW graph and the canonical acquisition order
# ---------------------------------------------------------------------------

def slw_graph(spec) -> dict[tuple[str, str], float]:
    """Static-lock-wait graph over ``spec``'s op templates.

    Edge ``(a, b) -> weight``: a transaction can hold a lock of class
    ``a`` while waiting for one of class ``b`` (``a`` locked at an
    earlier slot than ``b`` in the template's *current* program order),
    weighted by ``heat_a * heat_b`` — the static stand-in for how often
    two concurrent transactions actually collide on that hold-while-wait
    pattern. Re-sorting acquisition so hot classes come last moves the
    heavy edges to point *at* the hottest class from everywhere, which
    is exactly the configuration in which the hot lock's hold interval
    ``[acquire, last-use]`` is shortest.
    """
    heat = {c.name: c.heat for c in row_classes(spec)}
    edges: dict[tuple[str, str], float] = {}
    tmpl = [t for t in txn_template(spec) if t.wr]
    for i, u in enumerate(tmpl):
        for v in tmpl[i + 1:]:
            if u.cls == v.cls:
                continue            # same class = re-entrant, no wait
            k = (u.cls, v.cls)
            edges[k] = edges.get(k, 0.0) + heat[u.cls] * heat[v.cls]
    return edges


def acquisition_order(spec) -> list[str]:
    """Canonical class acquisition order: ascending heat, hot last.

    This is the order minimising the summed SLW weight held *across*
    each wait (for the single-template workloads here the minimiser of
    sum-of-heat-held-while-waiting is exactly ascending heat; asserting
    totality keeps the rank table a permutation). Deterministic: heat
    ties break on the class name.
    """
    classes = row_classes(spec)
    order = sorted(classes, key=lambda c: (c.heat, c.name))
    assert len({c.name for c in order}) == len(order)
    return [c.name for c in order]


def _key_heat(spec) -> np.ndarray:
    """(R,) float64 per-key heat (expected accesses/txn), host-side.

    The ``hot_base`` rotation mirrors ``gen_txn_dyn`` per kind exactly:
    only the hot set relocates — zipf kinds rotate the whole profile,
    hotspot_update moves THE hot row, fit/hotspot_scan move the hot/warm
    window while the uniform remainder keys stay where the generator
    draws them (unrotated)."""
    R = spec.n_rows
    heat = np.zeros(R, np.float64)
    hb = int(spec.hot_base) % R
    classes = {c.name: c for c in row_classes(spec)}
    if spec.kind in ("zipf", "hotspot_mix"):
        # zipf rank j sits AT key (hot_base + j) % R (workload.py rotates
        # the whole skew profile by hot_base)
        w = zipf_weights(R, spec.zipf_s)
        pmf = spec.txn_len * w / w.sum()
        heat[(hb + np.arange(R)) % R] = pmf
    elif spec.kind == "hotspot_update":
        # rest keys draw from [1, R) with the hot key dodge-swapped to 0
        heat[:] = classes["rest"].heat
        heat[hb] = classes["hot"].heat
    elif spec.kind == "hotspot_scan":
        warm = classes["warm"]
        heat[(np.arange(warm.lo, warm.hi) + hb) % R] = warm.heat
    elif spec.kind == "fit":
        # record inserts draw unrotated from [n_hot, R); the hot account
        # window rotates and may overlap them (drift's point) — max wins
        rec, hot = classes["record"], classes["hot_account"]
        heat[rec.lo:rec.hi] = rec.heat
        idx = (np.arange(hot.lo, hot.hi) + hb) % R
        heat[idx] = np.maximum(heat[idx], hot.heat)
    else:                       # uniform / tpcc: no hot_base semantics
        for c in classes.values():
            heat[c.lo:c.hi] = c.heat
    return heat


def acquisition_rank(spec) -> np.ndarray:
    """Per-key canonical lock-acquisition rank, (R,) i32 (numpy, host).

    ``rank`` is a permutation of ``[0, R)``: transactions under
    ``ordered_acquire`` lock their rows in ascending rank, so the
    hottest keys (highest heat) are locked last and held shortest.
    Host-side numpy (like ``zipf_cdf``); the engine moves it to its
    device in ``dyn_workload``.
    """
    heat = _key_heat(spec)
    order = np.lexsort((np.arange(spec.n_rows), heat))   # heat asc, key asc
    rank = np.empty(spec.n_rows, np.int32)
    rank[order] = np.arange(spec.n_rows, dtype=np.int32)
    return rank


def template_release_points(spec) -> list[int]:
    """Static per-slot release points: last slot that MAY touch the same
    rows (class-level may-alias). The engine refines this to the exact
    per-instance last use (:func:`last_use`); the template view is what
    the chopping argument reasons over — a slot whose class never recurs
    releases at itself, re-capturable classes release at their last
    occurrence."""
    tmpl = txn_template(spec)
    return [max(v.slot for v in tmpl if v.cls == u.cls) for u in tmpl]


@dataclasses.dataclass(frozen=True)
class ChopPlan:
    """The full static analysis of one workload (tests, docs, dumps)."""
    kind: str
    classes: tuple          # RowClass...
    template: tuple         # OpTemplate...
    slw: tuple              # ((cls_a, cls_b, weight), ...) sorted desc
    order: tuple            # canonical class acquisition order
    release: tuple          # per-template-slot release points

    def describe(self) -> str:
        lines = [f"chop[{self.kind}]"]
        lines.append("  classes: " + ", ".join(
            f"{c.name}[{c.lo}:{c.hi}) heat={c.heat:.2e}"
            for c in self.classes))
        lines.append("  template: " + " -> ".join(
            f"{t.cls}{'(w)' if t.wr else '(r)'}" for t in self.template))
        lines.append("  slw: " + (", ".join(
            f"{a}->{b}:{w:.1e}" for a, b, w in self.slw) or "(none)"))
        lines.append("  acquire order: " + " < ".join(self.order))
        lines.append(f"  release points: {list(self.release)}")
        return "\n".join(lines)


def chop(spec) -> ChopPlan:
    """Run the whole pipeline over one workload spec."""
    edges = sorted(((a, b, w) for (a, b), w in slw_graph(spec).items()),
                   key=lambda e: -e[2])
    return ChopPlan(
        kind=spec.kind,
        classes=tuple(row_classes(spec)),
        template=tuple(txn_template(spec)),
        slw=tuple(edges),
        order=tuple(acquisition_order(spec)),
        release=tuple(template_release_points(spec)))


# ---------------------------------------------------------------------------
# tensor helpers (consumed inside the engine step)
# ---------------------------------------------------------------------------

def apply_acquisition_order(rank: torch.Tensor, keys: torch.Tensor,
                            iswr: torch.Tensor, txn_len: int):
    """Re-sort each transaction's ACTIVE ops into canonical rank order.

    ``rank`` is the (R,) table from :func:`acquisition_rank` on the
    engine's device; ``keys`` / ``iswr`` are the (T, L) generated
    programs; ``txn_len`` bounds the active slots — padded slots keep
    their positions after every active one. The sort key
    ``rank * L + slot`` is unique per row, so the argsort is
    deterministic and same-key ops stay in program order. The caller
    applies this only when ``ordered_acquire`` is on (the flag is known
    on the host for a single-lane run).
    """
    T, L = keys.shape
    assert rank.shape[0] * L < int(_PAD_KEY), (
        f"chop sort key overflow: n_rows*L = {rank.shape[0] * L} "
        f">= {int(_PAD_KEY)}; shrink the key space or raise _PAD_KEY")
    slot = torch.arange(L, dtype=torch.int32, device=keys.device)[None, :]
    active = slot < txn_len
    skey = torch.where(active, rank[keys.long()] * L + slot,
                       int(_PAD_KEY) + slot)
    order = torch.argsort(skey, dim=1)
    return (torch.gather(keys, 1, order), torch.gather(iswr, 1, order))


def last_use(keys: torch.Tensor, nops: torch.Tensor) -> torch.Tensor:
    """(T, L) bool: slot is the LAST active slot touching its key.

    The per-instance release points: when the op at a last-use slot
    completes, the key's ticket has no further use in the transaction
    and may retire (``per_op_release``). The engine consumes the
    equivalent plane ``gen_txn_dyn`` returns (inlined there to reuse the
    dup analysis's eq tensor); the tests assert the two agree.
    """
    T, L = keys.shape
    slot = torch.arange(L, dtype=torch.int32, device=keys.device)
    active = slot[None, :] < nops[:, None]                   # (T, L)
    eq = keys[:, :, None] == keys[:, None, :]                # (T, L, L)
    later = (slot[None, :] > slot[:, None])[None]            # (1, L, L)
    has_later = torch.any(eq & later & active[:, None, :], dim=2)
    return active & ~has_later
