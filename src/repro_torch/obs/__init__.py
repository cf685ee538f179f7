"""Observability layer for the port's lock engine (``repro.obs`` in PyTorch).

* **Tick attribution**: the engine charges every thread-tick to a
  ``TickBreakdown`` bin (``Globals.tb``); :mod:`.breakdown` holds the
  conservation check (``sum(tb) == T * elapsed``) and report helpers.
* **Event tracing** (:mod:`.trace`): a fixed-allocation buffer on the
  engine's device capturing {tick, thread, row, event} every iteration;
  ``trace_on=False`` equals the untraced engine leaf for leaf.
* **Export** (:mod:`.export`): Chrome trace-event JSON (Perfetto) and text
  wait-profile / breakdown reports.
* **Step profiler** (:mod:`.prof`): stage ablation attributes the wall cost
  of one iteration to engine stages.
* **Hotspot attribution**: :mod:`.hotspot` ranks the per-record contention
  accumulator (``Globals.ca``) and checks its conservation against the
  TickBreakdown; :mod:`.blame` pairs wait spans with the holding
  transaction attempts (blame matrix, per-record table, longest chain).

The report modules are host numpy code, copies of the reference's that take
tensors on any device. ``repro.obs.compile_log`` (``jax.monitoring``
compile events, jit cache sizes) has no counterpart: eager torch compiles
nothing, so there is nothing to count.
"""
from . import blame, breakdown, export, hotspot, prof, trace
from .breakdown import (breakdown_row, check_conservation, fractions,
                        tick_sum)
from .prof import (STAGE_NOOPS, StageCost, StepProfile, profile_row,
                   profile_step, rank_table)
from .export import (breakdown_table, dump_chrome_trace, to_chrome_trace,
                     wait_profile)
from .blame import (BlameResult, blame_matrix, blame_table, critical_path)
from .hotspot import (check_ca_conservation, gini, hotspot_lane_events,
                      hotspot_report, hotspot_summary, top_share,
                      wait_share)
from .trace import (EVENTS, EV_ABORT, EV_COMMIT, EV_GRANT, EV_GROUP_JOIN,
                    EV_RELEASE, EV_TIMEOUT, EV_VICTIM, EV_WAIT_ENTER,
                    TraceBuf, events_host, make_trace, run_traced,
                    simulate_traced)

__all__ = [
    "blame", "breakdown", "export", "hotspot", "prof", "trace",
    "breakdown_row", "check_conservation", "fractions", "tick_sum",
    "STAGE_NOOPS", "StageCost", "StepProfile", "profile_row",
    "profile_step", "rank_table",
    "breakdown_table", "dump_chrome_trace", "to_chrome_trace",
    "wait_profile",
    "BlameResult", "blame_matrix", "blame_table", "critical_path",
    "check_ca_conservation", "gini", "hotspot_lane_events",
    "hotspot_report", "hotspot_summary", "top_share", "wait_share",
    "EVENTS", "EV_ABORT", "EV_COMMIT", "EV_GRANT", "EV_GROUP_JOIN",
    "EV_RELEASE", "EV_TIMEOUT", "EV_VICTIM", "EV_WAIT_ENTER",
    "TraceBuf", "events_host",
    "make_trace", "run_traced", "simulate_traced",
]
