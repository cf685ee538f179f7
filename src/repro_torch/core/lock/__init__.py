"""Concurrency-control engine (single lane): the paper's faithful layer."""
from . import chop
from .chop import ChopPlan
from .costs import CostModel, ProtocolParams, protocol_params, PROTOCOLS
from .workload import (WorkloadSpec, DynWorkload, dyn_workload, zipf_cdf,
                       zipf_cdf_table, DriftSchedule, DRIFT_KINDS,
                       stationary, hot_migration, skew_ramp, flash_crowd)
from .engine import (EngineConfig, StaticShape, DynParams, split_config,
                     SimState, init_state, init_state_dyn, run_sim, simulate,
                     N_TB, TB_NAMES, TB_BRANCHES, N_QHIST,
                     START, WAIT, EXEC, CWAIT, COMMIT, RBACK, RBWAIT,
                     BACKOFF, ARRIVE, HALT)
from .metrics import (SimResult, extract, extract_segment, delta_globals,
                      CSV_HEADER, TICKS_PER_SEC)

__all__ = [
    "chop", "ChopPlan",
    "CostModel", "ProtocolParams", "protocol_params", "PROTOCOLS",
    "WorkloadSpec", "DynWorkload", "dyn_workload", "zipf_cdf",
    "zipf_cdf_table", "DriftSchedule", "DRIFT_KINDS", "stationary",
    "hot_migration", "skew_ramp", "flash_crowd",
    "EngineConfig", "StaticShape", "DynParams", "split_config",
    "SimState", "init_state", "init_state_dyn", "run_sim", "simulate",
    "N_TB", "TB_NAMES", "TB_BRANCHES", "N_QHIST",
    "SimResult", "extract", "extract_segment", "delta_globals",
    "CSV_HEADER", "TICKS_PER_SEC",
]
