"""Concurrency-control engine: the paper's faithful reproduction layer."""
from . import chop
from .chop import ChopPlan
from .costs import CostModel, ProtocolParams, protocol_params, PROTOCOLS
from .workload import (WorkloadSpec, DynWorkload, dyn_workload, zipf_cdf,
                       zipf_cdf_table, DriftSchedule, DRIFT_KINDS,
                       stationary, hot_migration, skew_ramp, flash_crowd)
from .engine import (EngineConfig, StaticShape, DynParams, split_config,
                     SimState, SegSnapshot, init_state, init_state_dyn,
                     run_sim, run_segment, simulate, stack_lanes, take_lane,
                     N_TB, TB_NAMES, TB_BRANCHES, N_QHIST,
                     START, WAIT, EXEC, CWAIT, COMMIT, RBACK, RBWAIT,
                     BACKOFF, ARRIVE, HALT)
from .metrics import (SimResult, extract, extract_globals, extract_segment,
                      delta_globals, bench_row, CSV_HEADER, TICKS_PER_SEC)
from .aria import (AriaState, AriaMetrics, AriaConfig, AriaDyn, metrics_view,
                   split_aria, init_aria_state, batch_ticks, simulate_aria,
                   extract_aria)

__all__ = [
    "chop", "ChopPlan",
    "CostModel", "ProtocolParams", "protocol_params", "PROTOCOLS",
    "WorkloadSpec", "DynWorkload", "dyn_workload", "zipf_cdf",
    "zipf_cdf_table", "DriftSchedule", "DRIFT_KINDS", "stationary",
    "hot_migration", "skew_ramp", "flash_crowd",
    "EngineConfig", "StaticShape", "DynParams", "split_config",
    "SimState", "SegSnapshot", "init_state", "init_state_dyn",
    "run_sim", "run_segment", "simulate", "stack_lanes", "take_lane",
    "N_TB", "TB_NAMES", "TB_BRANCHES", "N_QHIST",
    "START", "WAIT", "EXEC", "CWAIT", "COMMIT", "RBACK", "RBWAIT",
    "BACKOFF", "ARRIVE", "HALT",
    "SimResult", "extract", "extract_globals", "extract_segment",
    "delta_globals", "bench_row", "CSV_HEADER", "TICKS_PER_SEC",
    "AriaState", "AriaMetrics", "AriaConfig", "AriaDyn", "metrics_view",
    "split_aria", "init_aria_state", "batch_ticks", "simulate_aria",
    "extract_aria",
]
