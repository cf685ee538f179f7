"""Correctness analysis of the port's lock engine (``repro.analysis`` in
PyTorch).

:mod:`.isolation` is the serializability certifier: it consumes the event
streams of :mod:`repro_torch.obs.trace` and proves each run's schedule
conflict-serializable under its protocol's discipline (txn-level ww
acyclicity, or piece level for chopped protocols), strict-2PL hold rules,
Brook ascending ranks, and dirty-read freedom under injected aborts.
``python -m repro_torch.analysis.cli`` runs it as a report.

``repro.analysis.jaxpr_lint`` has no counterpart: it certifies that no
config value is constant-folded into a captured JAX program, and the port
captures no graphs (every step is eager torch), so the check does not
apply.
"""
from . import isolation
from .isolation import (Attempt, Certificate, Edge, attempts_from_events,
                        certify, certify_run, dependency_graph, find_cycle,
                        total_trace_wait_ticks, validate_events)

__all__ = [
    "isolation",
    "Attempt", "Certificate", "Edge", "attempts_from_events", "certify",
    "certify_run", "dependency_graph", "find_cycle",
    "total_trace_wait_ticks", "validate_events",
]
