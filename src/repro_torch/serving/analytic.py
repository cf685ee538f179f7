"""Analytic open-system predictions (Thomasian, arXiv:2404.02276).

A copy of ``repro.serving.analytic`` (``math`` only) over the port's cost
tables and workload spec.

Thomasian's heterogeneous-data-access model treats an OLTP system as a
multi-server queue whose response time is service time plus queueing
delay, with lock contention entering as a service-time inflation. In the
low-contention regime (large key space, short transactions) the inflation
vanishes and the serving layer must match the plain M/M/c prediction —
that is the closed-form oracle tests/test_serving.py validates against,
the same differential-validation pattern ``ref_engine`` applies to the
closed-loop engine.

Pieces:

* :func:`service_ticks` — the uncontended per-transaction service time
  implied by the cost model (the chain ``ref_engine`` uses, generalized
  to read/write mixes).
* :func:`erlang_c` / :func:`mmc_wait_ticks` — the M/M/c queueing delay
  for ``c`` pool slots at arrival rate ``lam``.
* :func:`predicted_response_ticks` / :func:`predicted_util` — what the
  serving layer should measure below the knee, before boundary
  quantization (the runner observes completions only at segment
  boundaries; see DESIGN.md §10 for the ``+seg_ticks`` correction).

Service in the engine is near-deterministic, so the true queue is M/D/c
whose delay is about half of M/M/c's — both are well inside the test
tolerance below the knee, where delay is a small fraction of service
time. Above the knee (``rho >= 1``) the open system has no steady state:
the queue grows linearly and percentiles are horizon-bound, which is the
regime the fig17 knee curves exhibit rather than predict.
"""
from __future__ import annotations

import math

from ..core.lock.costs import CostModel, ProtocolParams, protocol_params
from ..core.lock.metrics import TICKS_PER_SEC
from ..core.lock.workload import WorkloadSpec

# workload kinds whose non-structural ops write with prob. write_ratio;
# structural slots (hotspot/fit/tpcc op 0..) are handled per kind below.
_ALL_WRITE_KINDS = ("zipf", "hotspot_scan")


def write_fraction(w: WorkloadSpec) -> float:
    """Expected fraction of a transaction's ops that are (locking) writes."""
    if w.reads_lock:
        return 1.0
    if w.kind in _ALL_WRITE_KINDS:
        return 1.0
    L = w.txn_len
    if w.kind == "hotspot_update":
        return (1.0 + (L - 1) * w.write_ratio) / L
    if w.kind in ("fit", "tpcc"):
        forced = min(2, L)
        return (forced + (L - forced) * w.write_ratio) / L
    return w.write_ratio        # uniform, hotspot_mix


def service_ticks(w: WorkloadSpec, costs: CostModel,
                  protocol: str | ProtocolParams = "mysql") -> float:
    """Uncontended mean service time of one transaction, in ticks.

    Every write op pays ``lock_base`` (instant uncontended grant; the
    deadlock-detection term is 0 at queue length 0) plus ``op_exec``;
    every read pays ``read_exec``; commit pays ``commit_base +
    sync_lat``. Duplicate-key writes (no fresh ticket) are ignored — they
    are vanishingly rare in the large-R regime this oracle serves.
    """
    p = (protocol_params(protocol) if isinstance(protocol, str)
         else protocol)
    fw = write_fraction(w)
    per_op = fw * (p.lock_base + costs.op_exec) + (1 - fw) * costs.read_exec
    return w.txn_len * per_op + costs.commit_base + costs.sync_lat


def erlang_c(c: int, a: float) -> float:
    """P(wait) in an M/M/c queue at offered load ``a = lam/mu`` erlangs.

    Computed via the numerically stable Erlang-B recurrence; requires
    ``a < c`` (below saturation).
    """
    assert 0 <= a < c
    b = 1.0
    for k in range(1, c + 1):
        b = a * b / (k + a * b)
    rho = a / c
    return b / (1.0 - rho + rho * b)


def mmc_wait_ticks(lam: float, s: float, c: int) -> float:
    """Mean M/M/c queueing delay (ticks) at ``lam`` arrivals/tick,
    service time ``s`` ticks, ``c`` servers. inf at/above saturation."""
    a = lam * s
    if a >= c:
        return math.inf
    return erlang_c(c, a) * s / (c - a)


def predicted_response_ticks(lam: float, w: WorkloadSpec, costs: CostModel,
                             c: int,
                             protocol: str | ProtocolParams = "mysql"
                             ) -> float:
    """Low-contention mean response time (ticks): service + M/M/c delay."""
    s = service_ticks(w, costs, protocol)
    return s + mmc_wait_ticks(lam, s, c)


def predicted_util(lam: float, w: WorkloadSpec, costs: CostModel, c: int,
                   protocol: str | ProtocolParams = "mysql") -> float:
    """Pool utilization ``lam * s / c`` (== engine ``cpu_util`` in the
    uncontended regime, where busy ticks are exactly service ticks)."""
    return min(lam * service_ticks(w, costs, protocol) / c, 1.0)


def pool_capacity_tps(w: WorkloadSpec, costs: CostModel, c: int,
                      protocol: str | ProtocolParams = "mysql") -> float:
    """Contention-free pool capacity (the knee's upper bound), in TPS."""
    return c * TICKS_PER_SEC / service_ticks(w, costs, protocol)
