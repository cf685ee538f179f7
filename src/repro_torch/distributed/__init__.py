"""Distributed planning of the port: sharding rules (planning only; nothing
executes a sharding on one card), failure detection with elastic re-mesh
planning, and straggler detection with rebalancing."""
from .sharding import (RULES, ResolveReport, resolve_spec, param_pspecs,
                       batch_pspec, cache_leaf_pspec, cache_pspecs,
                       data_axes)
from .fault import (HeartbeatMonitor, reshard_plan, plan_recovery,
                    RecoveryDecision, elastic_mesh_shape)
from .straggler import StragglerDetector, rebalance

__all__ = [
    "RULES", "ResolveReport", "resolve_spec", "param_pspecs",
    "batch_pspec", "cache_leaf_pspec", "cache_pspecs", "data_axes",
    "HeartbeatMonitor", "reshard_plan", "plan_recovery", "RecoveryDecision",
    "elastic_mesh_shape", "StragglerDetector", "rebalance",
]
