"""Distributed runtime of the port: sharding rules and their placement on
DTensor, failure detection with elastic re-mesh planning, and straggler
detection with rebalancing."""
from .sharding import (RULES, ResolveReport, resolve_spec, param_pspecs,
                       batch_pspec, cache_leaf_pspec, cache_pspecs,
                       data_axes, Sharding, param_shardings,
                       batch_shardings, cache_shardings, scalar_sharding,
                       distribute, annotate, set_activation_mesh, on_mesh)
from .fault import (HeartbeatMonitor, reshard_plan, plan_recovery,
                    RecoveryDecision, elastic_mesh_shape)
from .straggler import StragglerDetector, rebalance

__all__ = [
    "RULES", "ResolveReport", "resolve_spec", "param_pspecs",
    "batch_pspec", "cache_leaf_pspec", "cache_pspecs", "data_axes",
    "Sharding", "param_shardings", "batch_shardings", "cache_shardings",
    "scalar_sharding", "distribute", "annotate", "set_activation_mesh",
    "on_mesh",
    "HeartbeatMonitor", "reshard_plan", "plan_recovery", "RecoveryDecision",
    "elastic_mesh_shape", "StragglerDetector", "rebalance",
]
