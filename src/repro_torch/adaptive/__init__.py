"""Adaptive contention governor (DESIGN.md §7), in PyTorch: the port of
``repro.adaptive``.

Runs the lock engine in resumable time segments and re-decides the
protocol preset between segments from observed telemetry — the control
half of the paper's hotspot-aware switching, extended to non-stationary
(drifting) workloads. Every protocol flag, cost and workload parameter is
a per-lane value of the engine's step, so a switch costs nothing but the
new values.

Quickstart::

    from repro_torch.adaptive import (GovernorCell, QueueRulePolicy,
                                      run_governed)
    from repro_torch.core.lock import WorkloadSpec, skew_ramp
    drift = skew_ramp(WorkloadSpec(kind="zipf", txn_len=4), 12)
    res = run_governed(
        [GovernorCell("adaptive", QueueRulePolicy(), drift, n_threads=64)],
        horizon=240_000, n_segments=12, device="cuda")
"""
from .governor import (GUARD_CAP, GUARD_FLOOR, PRESETS, DEFAULT_ARMS,
                       guard_timeout, preset_params, preset_family,
                       switch_safe, SegmentRecord, Policy, FixedPolicy,
                       QueueRulePolicy, EpsilonGreedyPolicy)
from .runner import GovernorCell, run_governed, preset_timeline

__all__ = [
    "GUARD_CAP", "GUARD_FLOOR", "PRESETS", "DEFAULT_ARMS",
    "guard_timeout", "preset_params", "preset_family",
    "switch_safe", "SegmentRecord", "Policy", "FixedPolicy",
    "QueueRulePolicy", "EpsilonGreedyPolicy",
    "GovernorCell", "run_governed", "preset_timeline",
]
