"""Sweep-grid builders: declarative (protocol × workload × threads × ...)
point sets for the batched simulation runner (a copy of
``repro.sweep.grid`` over the port's own types).

A :class:`SweepPoint` is exactly the argument set of
``repro_torch.core.lock.simulate`` (or ``simulate_aria``), plus a name.
The builders here only produce lists of points; ``repro_torch.sweep.runner``
turns them into packed runs on the card.

``grid`` takes each axis as a scalar *or* a sequence and forms the
cartesian product over the sequence-valued ones; ``zip_grid`` zips
equal-length sequences instead (paired axes, e.g. one costs model per
protocol). ``expand`` fans one WorkloadSpec into tagged variants over its
fields (e.g. a Zipf-skew axis).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping

from ..core.lock import CostModel, WorkloadSpec

PROTOCOLS_ALL = ("mysql", "o1", "o2", "group", "bamboo", "brook2pl", "aria")


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One (protocol, workload, threads, ...) measurement request."""
    protocol: str
    workload: WorkloadSpec
    n_threads: int
    horizon: int
    p_abort: float = 0.0
    costs: CostModel = CostModel()
    drain: bool = False
    proto_over: tuple = ()      # sorted (key, value) protocol overrides
    name: str = ""
    tag: str = ""               # workload tag (used by name formatting)

    def over(self) -> dict:
        return dict(self.proto_over)


def _as_axis(v) -> list:
    """Normalize scalar-or-sequence axis values to a list."""
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def _workload_axis(workloads) -> list[tuple[str, WorkloadSpec]]:
    """Normalize workloads to [(tag, spec), ...]."""
    if isinstance(workloads, WorkloadSpec):
        return [(workloads.kind, workloads)]
    if isinstance(workloads, Mapping):
        return [(str(k), v) for k, v in workloads.items()]
    out = []
    for w in workloads:
        if isinstance(w, WorkloadSpec):
            out.append((w.kind, w))
        else:
            tag, spec = w
            out.append((str(tag), spec))
    return out


def _fmt_name(name_fmt: str, protocol: str, tag: str, spec: WorkloadSpec,
              n_threads: int, horizon: int, p_abort: float,
              costs: CostModel) -> str:
    return name_fmt.format(
        protocol=protocol, workload=tag, n_threads=n_threads,
        horizon=horizon, p_abort=p_abort, sync_lat=costs.sync_lat,
        zipf_s=spec.zipf_s, txn_len=spec.txn_len, kind=spec.kind)


def point(protocol: str, workload: WorkloadSpec, n_threads: int, *,
          horizon: int, p_abort: float = 0.0, costs: CostModel | None = None,
          drain: bool = False, name: str = "", tag: str = "",
          **proto_over) -> SweepPoint:
    """Build one fully-explicit sweep point (benchmarks with bespoke names)."""
    return SweepPoint(
        protocol=protocol, workload=workload, n_threads=int(n_threads),
        horizon=int(horizon), p_abort=float(p_abort),
        costs=costs or CostModel(), drain=drain,
        proto_over=tuple(sorted(proto_over.items())),
        name=name or f"{protocol}_{tag or workload.kind}_T{n_threads}",
        tag=tag or workload.kind)


def grid(protocols, workloads, n_threads, *, horizon, p_abort=0.0,
         costs=None, drain: bool = False,
         name_fmt: str = "{protocol}_{workload}_T{n_threads}",
         **proto_over) -> list[SweepPoint]:
    """Cartesian grid over every sequence-valued axis.

    ``protocols``, ``n_threads``, ``horizon``, ``p_abort``, ``costs`` each
    accept a scalar or a sequence; ``workloads`` accepts a WorkloadSpec, a
    {tag: spec} mapping, or a sequence of specs / (tag, spec) pairs.
    ``name_fmt`` may reference {protocol} {workload} {n_threads} {horizon}
    {p_abort} {sync_lat} {zipf_s} {txn_len} {kind}.
    """
    pts = []
    for (tag, spec), t, proto, pab, cm, hz in itertools.product(
            _workload_axis(workloads), _as_axis(n_threads),
            _as_axis(protocols), _as_axis(p_abort),
            _as_axis(costs if costs is not None else CostModel()),
            _as_axis(horizon)):
        cm = cm or CostModel()
        pts.append(point(
            proto, spec, t, horizon=hz, p_abort=pab, costs=cm, drain=drain,
            name=_fmt_name(name_fmt, proto, tag, spec, t, hz, pab, cm),
            tag=tag, **proto_over))
    return pts


def zip_grid(protocols, workloads, n_threads, *, horizon, p_abort=0.0,
             costs=None, drain: bool = False,
             name_fmt: str = "{protocol}_{workload}_T{n_threads}",
             **proto_over) -> list[SweepPoint]:
    """Zip equal-length axes into paired points (scalars broadcast)."""
    axes = {
        "workload": _workload_axis(workloads),
        "n_threads": _as_axis(n_threads),
        "protocol": _as_axis(protocols),
        "p_abort": _as_axis(p_abort),
        "costs": _as_axis(costs if costs is not None else CostModel()),
        "horizon": _as_axis(horizon),
    }
    n = max(len(v) for v in axes.values())
    for k, v in axes.items():
        if len(v) == 1:
            axes[k] = v * n
        elif len(v) != n:
            raise ValueError(f"zip_grid axis {k!r}: length {len(v)} != {n}")
    pts = []
    for (tag, spec), t, proto, pab, cm, hz in zip(
            axes["workload"], axes["n_threads"], axes["protocol"],
            axes["p_abort"], axes["costs"], axes["horizon"]):
        cm = cm or CostModel()
        pts.append(point(
            proto, spec, t, horizon=hz, p_abort=pab, costs=cm, drain=drain,
            name=_fmt_name(name_fmt, proto, tag, spec, t, hz, pab, cm),
            tag=tag, **proto_over))
    return pts


def expand(spec: WorkloadSpec, tag_fmt: str | None = None,
           **field_axes) -> list[tuple[str, WorkloadSpec]]:
    """Fan one WorkloadSpec into tagged variants over its fields.

    >>> expand(WorkloadSpec(kind="zipf"), zipf_s=[0.7, 0.99])
    [("zipf_s0.7", ...), ("zipf_s0.99", ...)]
    """
    keys = list(field_axes)
    out = []
    for combo in itertools.product(*(_as_axis(field_axes[k]) for k in keys)):
        repl = dict(zip(keys, combo))
        variant = dataclasses.replace(spec, **repl)
        if tag_fmt:
            tag = tag_fmt.format(kind=spec.kind, **repl)
        else:
            tag = spec.kind + "_" + "_".join(
                f"{k[0] if len(keys) > 1 else k}{v}" for k, v in repl.items())
        out.append((tag, variant))
    return out
