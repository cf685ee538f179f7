"""Port parity of the stage-ablation seam and the step profiler
(``repro_torch.obs.prof``) against ``repro.obs.prof`` on the CPU.

- every tests/test_prof.py ``NOOP_CASES`` ablation is the exact identity
  on the port's step, ``tick_charge`` touches only ``g.tb``, and the empty
  ablation is the production step;
- every stage's stand-in equals the reference's on a contended config,
  where it does change the run (the profiler removes the same work);
- the step never writes into its input (every variant is timed from one
  warmed state) and the untraced step issues the torch calls it issued
  before the event output existed (``tools/step_calls.py``);
- ``profile_step`` partitions its measurement: fractions sum to 1, one
  step variant per stage plus the full step.

tests/test_prof.py's compile-telemetry tests (``compile_log``) have no
counterpart: eager torch compiles nothing.
"""
import copy
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.lock import engine as ref_engine
from repro.core.lock import (CostModel as RefCostModel,
                             WorkloadSpec as RefWorkloadSpec)
from repro_torch.core.lock import (CostModel, EngineConfig, WorkloadSpec,
                                   convert, engine, protocol_params)
from repro_torch.obs.prof import (STAGE_NOOPS, profile_row, profile_step,
                                  rank_table)

N_STEPS = 40
ROOT = Path(__file__).resolve().parents[1]

# torch calls of one untraced iteration per protocol (tools/step_calls.py,
# hotspot update, txn_len 4, R=256, T=16, attribution on, p_abort 0.05),
# read on the commit before the step gained its event output and ablation
# seam; the untraced step must keep them
STEP_CALLS = {"mysql": 846, "o1": 846, "o2": 774, "group": 833,
              "bamboo": 847, "brook2pl": 760}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(proto, *, txn_len=4, write_ratio=1.0, kind="hotspot_update",
          threads=8, rows=64):
    wl = dict(kind=kind, txn_len=txn_len, n_rows=rows,
              write_ratio=write_ratio)
    run = dict(n_threads=threads, horizon=500_000)
    ref = ref_engine.EngineConfig(
        protocol=ref_engine.protocol_params(proto), costs=RefCostModel(),
        workload=RefWorkloadSpec(**wl), **run)
    port = EngineConfig(protocol=protocol_params(proto), costs=CostModel(),
                        workload=WorkloadSpec(**wl), **run)
    return ref, port


def _port_steps(cfg, ablate=frozenset()):
    stat, dp = engine.split_config(cfg, device="cpu")
    step = engine._make_step(stat, engine._lanes(dp), ablate=ablate)
    s = engine._unsqueeze(engine.init_state_dyn(stat, dp))
    for _ in range(N_STEPS):
        s = step(s)
    return convert.state_to_numpy(engine.take_lane(s, 0))


def _ref_steps(cfg, ablate=frozenset()):
    stat, dp = ref_engine.split_config(cfg)
    step = jax.jit(ref_engine._make_step(stat, dp, ablate=ablate))
    s = ref_engine.init_state_dyn(stat, dp)
    for _ in range(N_STEPS):
        s = step(s)
    return jax.tree.map(np.asarray, s)


def _leaf_diffs(a, b):
    return [f"{part}.{f}" for part in ("th", "rows", "g")
            for f, x, y in zip(getattr(a, part)._fields, getattr(a, part),
                               getattr(b, part))
            if not (x.dtype == y.dtype and np.array_equal(x, y))]


# (stage, protocol, config overrides) under which the ablation must be the
# identity: tests/test_prof.py's NOOP_CASES
NOOP_CASES = [
    ("dup_analysis", "mysql", dict(txn_len=1)),
    ("deadlock_walk", "brook2pl", {}),
    ("ticket_grant", "mysql", dict(kind="uniform", write_ratio=0.0)),
    ("commit_cursor", "mysql", dict(kind="uniform", write_ratio=0.0)),
    ("group_hotspot", "mysql", {}),
    ("group_hotspot", "brook2pl", {}),
]


@pytest.mark.parametrize("stage,proto,over", NOOP_CASES,
                         ids=[f"{s}-{p}-{'-'.join(map(str, o.values()))}"
                              for s, p, o in NOOP_CASES])
def test_ablation_is_the_identity_under_its_noop_config(stage, proto, over):
    _ref, cfg = _cfgs(proto, **over)
    full = _port_steps(cfg)
    assert _leaf_diffs(full, _port_steps(cfg, frozenset({stage}))) == []
    assert int(full.g.commits) > 0 or int(full.g.now) > 0


# (stage, protocol, config overrides) under which the stage does work:
# deadlocks need detection and a small key space, a hot row > 32 waiters
ACTIVE_CASES = [
    ("dup_analysis", "group", dict(threads=16)),
    ("deadlock_walk", "mysql", dict(kind="zipf", rows=16, threads=16)),
    ("ticket_grant", "group", dict(threads=16)),
    ("commit_cursor", "group", dict(threads=16)),
    ("group_hotspot", "group", dict(threads=48)),
    ("tick_charge", "group", dict(threads=16)),
]


@pytest.mark.parametrize("stage,proto,over", ACTIVE_CASES,
                         ids=[s for s, _, _ in ACTIVE_CASES])
def test_stand_in_equals_the_reference_where_it_changes_the_run(stage, proto,
                                                                over):
    ref_cfg, cfg = _cfgs(proto, **over)
    ablate = frozenset({stage})
    got, want = _port_steps(cfg, ablate), _ref_steps(ref_cfg, ablate)
    assert _leaf_diffs(got, want) == []
    assert _leaf_diffs(got, _port_steps(cfg)) != []


def test_tick_charge_ablation_touches_only_tb():
    _ref, cfg = _cfgs("mysql")
    full = _port_steps(cfg)
    abl = _port_steps(cfg, frozenset({"tick_charge"}))
    assert _leaf_diffs(full, abl) == ["g.tb"]
    assert int(full.g.tb.sum()) > 0 and int(abl.g.tb.sum()) == 0


def test_empty_ablation_is_the_production_step():
    _ref, cfg = _cfgs("group")
    stat, dp = engine.split_config(cfg, device="cpu")
    lp = engine._lanes(dp)
    s = engine._unsqueeze(engine.init_state_dyn(stat, dp))
    plain, events = engine._make_step(stat, lp), \
        engine._make_step_events(stat, lp, ablate=frozenset())
    a = b = s
    for _ in range(N_STEPS):
        a, (b, _ev) = plain(a), events(b)
    assert _leaf_diffs(convert.state_to_numpy(a),
                       convert.state_to_numpy(b)) == []


def test_unknown_stage_rejected():
    _ref, cfg = _cfgs("mysql")
    stat, dp = engine.split_config(cfg, device="cpu")
    with pytest.raises(ValueError):
        engine._make_step(stat, engine._lanes(dp),
                          ablate=frozenset({"nonsense"}))
    with pytest.raises(ValueError):
        profile_step(cfg, stages=("nonsense",), device="cpu")


def test_stage_noops_cover_prof_stages():
    assert engine.PROF_STAGES == ref_engine.PROF_STAGES
    assert set(STAGE_NOOPS) == set(engine.PROF_STAGES)
    tested = {s for s, _, _ in NOOP_CASES} | {"tick_charge"}
    assert tested == set(engine.PROF_STAGES)


def test_step_never_writes_into_its_input():
    _ref, cfg = _cfgs("group", threads=16)
    stat, dp = engine.split_config(cfg, device="cpu")
    s = engine._unsqueeze(engine.init_state_dyn(stat, dp))
    for ablate in [frozenset()] + [frozenset({p})
                                   for p in engine.PROF_STAGES]:
        step = engine._make_step(stat, engine._lanes(dp), ablate=ablate)
        for _ in range(8):
            before = copy.deepcopy(convert.state_to_numpy(s))
            nxt = step(s)
            assert _leaf_diffs(before, convert.state_to_numpy(s)) == []
            s = nxt


def _step_calls_tool():
    spec = importlib.util.spec_from_file_location(
        "step_calls", ROOT / "tools" / "step_calls.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_untraced_step_keeps_its_torch_calls():
    tool = _step_calls_tool()
    got = {p: tool.step_calls(p) for p in tool.PROTOCOLS}
    assert got == STEP_CALLS


def test_profile_step_partitions_cost():
    _ref, cfg = _cfgs("mysql", threads=16)
    prof = profile_step(cfg, n_iters=16, repeats=1,
                        stages=("commit_cursor", "tick_charge"),
                        device="cpu")
    assert prof.compiles == 3
    names = [s.stage for s in prof.stages]
    assert names[-1] == "other"
    assert set(names) == {"commit_cursor", "tick_charge", "other"}
    assert abs(sum(s.fraction for s in prof.stages) - 1.0) < 1e-9
    assert all(s.us_per_iter >= 0.0 for s in prof.stages)
    assert prof.us_per_iter > 0.0
    assert prof.dominant.stage != "other"
    assert prof.stat == engine.StaticShape("hotspot_update", 16, 4, 64)
    assert "dominant:" in rank_table(prof)
    row = profile_row("profile_test", prof)
    assert row.startswith("profile_test,") and "dominant=" in row
    assert row.endswith(";compiles=3")

