"""Analytic steady-state oracle for single-hotspot workloads.

For the pure hotspot-update workload (every transaction = one write to one
row), each protocol's throughput is determined by its per-commit serial
chain on that row — closed forms the engine must match (differential
validation of the tick simulator; tests assert agreement within 15%).

Chains (ticks/commit at saturation, T threads, see costs.py semantics):
  mysql/o1 : grant overhead (lock_base + dd_coeff * queue) + op + commit
             (strict 2PL: successor granted only after commit completes)
  o2       : lock_base + op + commit           (no deadlock detection)
  bamboo   : lock_base + dd_coeff * queue + op (early release: commit off
             the serial path; commits pipeline)
  group    : grant_cost + op, amortized lock_base per batch; commits
             batch off-path (group commit)
  brook2pl : lock_base + op (no detection on the grant path; per-op
             release retires the hot ticket at its last use, so the
             commit — like bamboo's — pipelines off the serial chain)
  serial(1): lock_base + op + commit (queue length 0)
"""
from __future__ import annotations

from .costs import CostModel, ProtocolParams, protocol_params
from .metrics import TICKS_PER_SEC


def predicted_tps(proto: str, n_threads: int, costs: CostModel,
                  params: ProtocolParams | None = None) -> float:
    p = params or protocol_params(proto)
    c = costs
    commit = c.commit_base + c.sync_lat
    q = max(n_threads - 1, 0)
    if n_threads == 1:
        chain = p.lock_base + c.op_exec + commit
    elif proto in ("mysql", "o1"):
        chain = p.lock_base + p.dd_coeff * q + c.op_exec + commit
    elif proto == "o2":
        chain = p.lock_base + c.op_exec + commit
    elif proto == "bamboo":
        chain = p.lock_base + p.dd_coeff * q + c.op_exec
    elif proto == "group":
        chain = p.grant_cost + c.op_exec + p.lock_base / max(
            p.batch_size, 1)
    elif proto == "brook2pl":
        chain = (p.lock_base + c.op_exec if p.per_op_release
                 else p.lock_base + c.op_exec + commit)
    else:  # pragma: no cover
        raise ValueError(proto)
    return TICKS_PER_SEC / chain
