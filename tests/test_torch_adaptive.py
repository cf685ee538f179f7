"""Port parity for the adaptive governor (``repro_torch.adaptive``): the cases
of ``tests/test_adaptive.py`` that drive the governor — TestSegmentedParity's
counter split, TestPolicies, TestRunGoverned, TestStoreV3 and
TestBrookSwitchIn — run through both packages on the same inputs. Every
governed run of the port equals the reference's: the whole-run metrics
(every ``SimResult`` field), the per-segment records (``segments``, the
histograms, breakdowns and hotspots included) and the preset timelines.
Each reference result is computed once per module (fixtures).

Horizons cut from ``tests/test_adaptive.py``'s, so that this file stays
near two minutes on one CPU core (the port's eager engine costs ~4 ms an
iteration at T=64 there):

* TestBrookSwitchIn's switch-in recovery 240,000 -> 60,000 ticks (6
  segments); brook_guard -> brook2pl 120,000 -> 30,000; the two-hop bypass
  120,000 -> 60,000; the rank-rotating drift 120,000 -> 24,000 (6
  segments, the guard on its 20,000 floor as before); the stable-rank ramp
  120,000 -> 16,000; the fixed brook_guard run 240,000 -> 36,000 (6
  segments: the guard on its floor as before); the last-boundary switch
  480,000 -> 160,000 (4 segments: the guard on its 20,000 floor instead of
  60,000, half a segment or less either way).

Cases of ``tests/test_adaptive.py`` with no counterpart on one card:

* ``TestCompileCounter::test_switches_cost_zero_recompiles`` and the
  ``n_compiles == 1`` assertion of
  ``TestRunGoverned::test_records_and_totals_consistent`` count JAX's jit
  cache. The port compiles nothing per shape (eager torch), so
  ``n_compiles`` is 0 on every governed run (checked below).
* The engine-level cases of TestSegmentedParity (segmented vs single-shot
  state leaves) and TestDriftSchedules are held to the reference in
  ``test_torch_engine_batch.py`` and ``test_torch_workload.py``.
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.adaptive as ref_adaptive
import repro.core.lock as ref_lock
import repro.sweep as ref_sweep
import repro_torch.adaptive as port_adaptive
import repro_torch.core.lock as port_lock
import repro_torch.sweep as port_sweep
from repro.core.lock import engine as ref_engine
from repro.core.lock.metrics import delta_globals as ref_delta
from repro_torch.core.lock import engine as port_engine
from repro_torch.core.lock.metrics import delta_globals as port_delta
from repro_torch.sweep.runner import run_packed_segment

REF = SimpleNamespace(name="ref", A=ref_adaptive, L=ref_lock, S=ref_sweep,
                      E=ref_engine, kw={})
PORT = SimpleNamespace(name="port", A=port_adaptive, L=port_lock,
                       S=port_sweep, E=port_engine, kw={"device": "cpu"})

HORIZON = 30_000


def zipf(ns, **kw):
    return ns.L.WorkloadSpec(**{**dict(kind="zipf", txn_len=2, n_rows=256,
                                       zipf_s=0.9), **kw})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, set before the module's shared runs (the test
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def governed(ns, cells, **kw):
    return ns.A.run_governed(cells, **kw, **ns.kw)


def both(build, **kw):
    """Run ``build(ns)``'s cells through both packages: (reference, port)."""
    return governed(REF, build(REF), **kw), governed(PORT, build(PORT), **kw)


def assert_same(ref, port, names):
    """Whole-run metrics, per-segment records and preset timelines equal."""
    assert port.names() == ref.names()
    assert port.n_compiles == 0
    for n in names:
        assert dataclasses.asdict(port[n]) == dataclasses.asdict(ref[n]), n
        assert port.segments[n] == ref.segments[n], n
        assert (port_adaptive.preset_timeline(port, n)
                == ref_adaptive.preset_timeline(ref, n)), n
    assert ([(b.kind, b.n_rows, b.pad_threads, b.pad_len, b.n_points)
             for b in port.buckets]
            == [(b.kind, b.n_rows, b.pad_threads, b.pad_len, b.n_points)
                for b in ref.buckets])


# ---------------------------------------------------------------------------
# TestSegmentedParity: the counter split the governor's records rest on
# ---------------------------------------------------------------------------

def _np_leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _np_leaves(t)]
    return [np.asarray(tree)]


def test_delta_globals_splits_counters():
    gs = {}
    for ns in (REF, PORT):
        cfg = ns.E.EngineConfig(protocol=ns.L.protocol_params("group"),
                                costs=ns.L.CostModel(), workload=zipf(ns),
                                n_threads=8, horizon=HORIZON)
        stat, dp = ns.L.split_config(cfg, **ns.kw)
        s = ns.E.init_state_dyn(stat, dp)
        gs[ns.name] = [s.g]
        for until in (HORIZON // 2, HORIZON):
            s, _ = ns.E.run_segment(stat, dp, s, until)
            gs[ns.name].append(s.g)
    r, p = gs["ref"], gs["port"]
    for a, b in zip(r, p):
        for x, y in zip(_np_leaves(a), _np_leaves(b)):
            np.testing.assert_array_equal(x, y)
    d01, d12 = port_delta(p[0], p[1]), port_delta(p[1], p[2])
    assert int(d01.commits) + int(d12.commits) == int(p[2].commits)
    assert int(d01.now) + int(d12.now) == int(p[2].now)
    np.testing.assert_array_equal((d01.hist + d12.hist).numpy(),
                                  p[2].hist.numpy())
    for x, y in zip(_np_leaves(ref_delta(r[1], r[2])),
                    _np_leaves(d12)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# TestPolicies: host code, the same decisions in both packages
# ---------------------------------------------------------------------------

def _rec(ns, index=0, preset="o2", tps=1e6, max_qlen=0, n_waiting=0,
         lock_wait_frac=0.0, n_threads=64):
    m = ns.L.SimResult(protocol=preset, n_threads=n_threads, commits=1000,
                       user_aborts=0, forced_aborts=0, lock_ops=0,
                       sim_seconds=0.01, tps=tps, mean_latency_us=1.0,
                       p95_latency_us=1.0, p99_latency_us=1.0,
                       lock_wait_frac=lock_wait_frac, cpu_util=0.5,
                       abort_rate=0.0, iters=10)
    return ns.A.SegmentRecord(index=index, t0=0, t1=1000, preset=preset,
                              metrics=m, max_qlen=max_qlen, n_hot=0,
                              n_live=0, n_waiting=n_waiting)


def test_tables_and_guard_equal():
    assert port_adaptive.PRESETS == ref_adaptive.PRESETS
    assert port_adaptive.DEFAULT_ARMS == ref_adaptive.DEFAULT_ARMS
    assert (port_adaptive.GUARD_FLOOR, port_adaptive.GUARD_CAP) == (
        ref_adaptive.GUARD_FLOOR, ref_adaptive.GUARD_CAP)
    for name in port_adaptive.PRESETS:
        assert port_adaptive.switch_safe(name) == ref_adaptive.switch_safe(
            name), name
        assert (port_adaptive.preset_family(name)
                == ref_adaptive.preset_family(name))
        for seg in (None, (480_000, 4), (240_000, 6), (2_000_000, 4)):
            kw = {} if seg is None else dict(horizon=seg[0],
                                             n_segments=seg[1])
            assert (dataclasses.asdict(port_adaptive.preset_params(name, **kw))
                    == dataclasses.asdict(ref_adaptive.preset_params(
                        name, **kw))), (name, seg)
    for h, n in ((480_000, 4), (240_000, 6), (2_000_000, 4), (1000, 0)):
        assert port_adaptive.guard_timeout(h, n) == \
            ref_adaptive.guard_timeout(h, n)


@pytest.mark.parametrize("ns", [REF, PORT], ids=["ref", "port"])
class TestPolicies:
    def test_fixed(self, ns):
        p = ns.A.FixedPolicy("group")
        p.reset(64)
        assert p.decide(0, []) == "group"
        assert p.decide(5, [_rec(ns)]) == "group"

    def test_rule_branches(self, ns):
        p = ns.A.QueueRulePolicy()
        p.reset(64)
        assert p.decide(0, []) == "o2"
        assert p.decide(1, [_rec(ns, max_qlen=60, n_waiting=62)]) == "group"
        assert p.decide(1, [_rec(ns, max_qlen=25, n_waiting=60)]) == "mysql"
        assert p.decide(1, [_rec(ns, preset="mysql", max_qlen=1,
                                 n_waiting=2, lock_wait_frac=0.01)]) == "o2"
        assert p.decide(1, [_rec(ns, preset="mysql", max_qlen=3,
                                 n_waiting=12,
                                 lock_wait_frac=0.2)]) == "mysql"

    def test_greedy_bootstrap_then_exploit(self, ns):
        p = ns.A.EpsilonGreedyPolicy(arms=ns.A.DEFAULT_ARMS)
        p.reset(64)
        hist = []
        for k, (arm, tps) in enumerate(zip(ns.A.DEFAULT_ARMS,
                                           (3e6, 2e6, 1e6))):
            assert p.decide(k, hist) == arm
            hist.append(_rec(ns, index=k, preset=arm, tps=tps))
        assert p.decide(3, hist) == "o2"

    def test_greedy_drop_taints_family_and_reprobes(self, ns):
        p = ns.A.EpsilonGreedyPolicy(arms=ns.A.DEFAULT_ARMS, drop_frac=0.5)
        p.reset(64)
        hist = []
        script = {"o2": [3e6, 4e6, 10_000.0],
                  "group": [2.5e6], "mysql": [2e6, 1.5e6, 1.5e6]}
        chosen = []
        for k in range(7):
            arm = p.decide(k, hist)
            chosen.append(arm)
            hist.append(_rec(ns, index=k, preset=arm,
                             tps=script[arm].pop(0)))
        assert chosen == ["o2", "group", "mysql", "o2", "o2",
                          "mysql", "mysql"]
        assert p.est["group"] == 10_000.0


def test_greedy_with_scheduled_exploration_decides_alike():
    """``explore_every`` and decay, driven over a long synthetic history:
    both packages choose the same arm at every step."""
    chosen = {}
    for ns in (REF, PORT):
        p = ns.A.EpsilonGreedyPolicy(explore_every=3, decay=0.7)
        p.reset(32)
        hist, out = [], []
        rng = np.random.default_rng(5)
        for k in range(40):
            arm = p.decide(k, hist)
            out.append(arm)
            hist.append(_rec(ns, index=k, preset=arm,
                             tps=float(rng.integers(1, 10)) * 1e5))
        chosen[ns.name] = out
    assert chosen["port"] == chosen["ref"]


# ---------------------------------------------------------------------------
# TestRunGoverned
# ---------------------------------------------------------------------------

METRIC_FIELDS = ("commits", "user_aborts", "forced_aborts", "lock_ops",
                 "tps", "mean_latency_us", "p95_latency_us", "abort_rate",
                 "lock_wait_frac", "cpu_util")


@pytest.fixture(scope="module")
def fixed_stationary():
    return both(lambda ns: [ns.A.GovernorCell(
        "cell", ns.A.FixedPolicy("group"), ns.L.stationary(zipf(ns), 4), 8)],
        horizon=HORIZON, n_segments=4)


def test_fixed_stationary_cell_matches_simulate(fixed_stationary):
    ref, port = fixed_stationary
    assert_same(ref, port, ["cell"])
    single = port_lock.extract("group", 8, port_lock.simulate(
        "group", zipf(PORT), n_threads=8, horizon=HORIZON, device="cpu"))
    for f in METRIC_FIELDS:
        assert getattr(port["cell"], f) == getattr(single, f), f
    assert 0 <= port["cell"].iters - single.iters <= 3


@pytest.fixture(scope="module")
def records_and_totals():
    def build(ns):
        drift = ns.L.skew_ramp(zipf(ns, n_rows=257), 4, lo=0.3, hi=1.1)
        return [ns.A.GovernorCell("a", ns.A.QueueRulePolicy(), drift, 8),
                ns.A.GovernorCell("b", ns.A.FixedPolicy("mysql"), drift, 8)]
    return both(build, horizon=HORIZON, n_segments=4)


def test_records_and_totals_consistent(records_and_totals):
    ref, port = records_and_totals
    assert_same(ref, port, ["a", "b"])
    for name in ("a", "b"):
        segs = port.segments[name]
        assert len(segs) == 4
        for s, bound in zip(segs, (HORIZON * k // 4 for k in range(1, 5))):
            assert bound <= s["t1"] <= HORIZON
            assert s["t0"] < s["t1"]
        assert sum(s["commits"] for s in segs) == port[name].commits
        assert port_adaptive.preset_timeline(port, name)[0] in ("o2",
                                                                 "mysql")
    rows = port_sweep.summarize(port)
    assert len(rows) == 2 and rows[0].startswith("a,")
    assert [r.split(",", 2)[2] for r in rows] == [
        r.split(",", 2)[2] for r in ref_sweep.summarize(ref)]


def test_packed_segment_substrate_bitexact_per_lane():
    """run_packed_segment (shared by the governed runner, serving and the
    sweep's compaction scheduler) equals per-lane run_segment in every state
    leaf and snapshot — heterogeneous protocols, drift-schedule workloads,
    per-lane untils and the resident packed resume (``packed=``) — and the
    port's packed lanes equal the reference's single lanes."""
    from repro.sweep.runner import run_packed_segment as ref_packed
    from repro.sweep.runner import _take as ref_take

    def setup(ns):
        drift = ns.L.hot_migration(
            ns.L.WorkloadSpec(kind="hotspot_update", txn_len=2,
                              n_rows=1024), 4, n_sites=4, period=1)
        cfg0 = ns.E.EngineConfig(protocol=ns.L.protocol_params("group"),
                                 costs=ns.L.CostModel(),
                                 workload=drift.spec(0), n_threads=8,
                                 horizon=HORIZON)
        stat, _ = ns.L.split_config(cfg0, pad_threads=64, **ns.kw)
        dps, states = [], []
        for i, proto in enumerate(("group", "mysql", "o2")):
            _, dp = ns.L.split_config(dataclasses.replace(
                cfg0, protocol=ns.L.protocol_params(proto),
                workload=drift.spec(i)), pad_threads=64, **ns.kw)
            dps.append(dp)
            states.append(ns.E.init_state_dyn(stat, dp))
        return stat, dps, states

    untils, untils2 = [10_000, 14_000, 18_000], [20_000, 24_000, 28_000]
    stat, dps, states = setup(PORT)
    packed, snaps, w = run_packed_segment(stat, dps, states, untils)
    assert w == 4
    packed2, _, _ = run_packed_segment(stat, dps, None, untils2,
                                       packed=packed)
    rstat, rdps, rstates = setup(REF)
    rpacked, rsnaps, _ = ref_packed(rstat, rdps, rstates, untils)
    rpacked2, _, _ = ref_packed(rstat, rdps, None, untils2, packed=rpacked)

    for i in range(3):
        ref, ref_snap = port_engine.run_segment(stat, dps[i], states[i],
                                                untils[i])
        for a, b in zip(_np_leaves(port_engine.take_lane(packed, i)),
                        _np_leaves(ref)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_np_leaves(port_engine.take_lane(snaps, i)),
                        _np_leaves(ref_snap)):
            np.testing.assert_array_equal(a, b)
        ref2, _ = port_engine.run_segment(stat, dps[i], ref, untils2[i])
        got2 = _np_leaves(port_engine.take_lane(packed2, i))
        for a, b in zip(got2, _np_leaves(ref2)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got2, _np_leaves(ref_take(rpacked2, i))):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_np_leaves(port_engine.take_lane(snaps, i)),
                        _np_leaves(ref_take(rsnaps, i))):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def batched_vs_sequential():
    def build(ns):
        drift = ns.L.skew_ramp(zipf(ns), 3, lo=0.3, hi=1.1)
        return [ns.A.GovernorCell("r", ns.A.QueueRulePolicy(), drift, 8),
                ns.A.GovernorCell("m", ns.A.FixedPolicy("mysql"), drift, 12),
                ns.A.GovernorCell("g", ns.A.FixedPolicy("group"), drift, 8)]
    kw = dict(horizon=HORIZON, n_segments=3)
    return (governed(REF, build(REF), chunk_size=1, **kw),
            {cs: governed(PORT, build(PORT), chunk_size=cs, **kw)
             for cs in (1, 4)})


@pytest.mark.parametrize("chunk_size", [1, 4])
def test_batched_lanes_match_sequential(batched_vs_sequential, chunk_size):
    """The port at chunk_size 1 (single lanes) and 4 (one pack) equals the
    reference's sequential run, switches included."""
    ref, port = batched_vs_sequential
    assert_same(ref, port[chunk_size], ["r", "m", "g"])
    assert port[chunk_size].lane_iters > 0


def test_duplicate_cell_names_rejected():
    drift = port_lock.stationary(zipf(PORT), 2)
    cells = [port_adaptive.GovernorCell(
        "x", port_adaptive.FixedPolicy("o2"), drift, 8)] * 2
    with pytest.raises(ValueError, match="duplicate"):
        port_adaptive.run_governed(cells, horizon=1000, n_segments=2,
                                   device="cpu")


# ---------------------------------------------------------------------------
# TestStoreV3, across packages
# ---------------------------------------------------------------------------

def test_store_roundtrip_with_segments_across_packages(tmp_path):
    ref, port = both(lambda ns: [ns.A.GovernorCell(
        "cell", ns.A.FixedPolicy("o2"), ns.L.stationary(zipf(ns), 3), 8)],
        horizon=HORIZON, n_segments=3)
    assert_same(ref, port, ["cell"])
    p_path = os.path.join(tmp_path, "port.json")
    r_path = os.path.join(tmp_path, "ref.json")
    port_sweep.save_results(p_path, port, meta={"tag": "t"})
    ref_sweep.save_results(r_path, ref, meta={"tag": "t"})
    # each package reads the other's document; the points are the same
    for load, path in ((ref_sweep.load_results, p_path),
                       (port_sweep.load_results, r_path)):
        doc = load(path)
        assert doc["schema"] == "repro.sweep/v4"
        rec = doc["points"][0]
        assert len(rec["segments"]) == 3
        assert rec["segments"][0]["preset"] == "o2"
        assert rec["metrics"]["commits"] == port["cell"].commits
        pad_t = 64
        for seg in rec["segments"]:
            bd = seg["breakdown"]
            assert set(bd) == set(port_engine.TB_NAMES)
            assert sum(bd.values()) == pad_t * (seg["t1"] - seg["t0"])
            assert sum(seg["wait_hist"]) == zipf(PORT).n_rows
            assert sum(seg["occ_hist"]) == seg["n_hot"]
    docs = []
    for path in (p_path, r_path):
        with open(path) as f:
            docs.append([{k: v for k, v in rec.items() if k != "wall_us"}
                         for rec in json.load(f)["points"]])
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------------
# TestBrookSwitchIn
# ---------------------------------------------------------------------------

BROOK_W = dict(kind="zipf", zipf_s=1.1, txn_len=4, n_rows=256)


def brook_w(ns, **kw):
    return ns.L.WorkloadSpec(**{**BROOK_W, **kw})


def _switch(ns, first, then):
    class Switch(ns.A.Policy):
        name = f"switch:{first}->{then}"

        def decide(self, k, history):
            return first if k == 0 else then
    return Switch()


def _by_segment(ns, presets, name):
    class BySegment(ns.A.Policy):
        def decide(self, k, history):
            return presets[min(k, len(presets) - 1)]
    p = BySegment()
    p.name = name
    return p


@pytest.mark.parametrize("ns", [REF, PORT], ids=["ref", "port"])
def test_pure_brook_switch_in_rejected_loudly(ns):
    assert not ns.A.switch_safe("brook2pl")
    assert not ns.A.switch_safe("brook_hold")
    assert ns.A.switch_safe("brook_guard") and ns.A.switch_safe("mysql")
    cell = ns.A.GovernorCell("swt_brook2pl", _switch(ns, "mysql", "brook2pl"),
                             ns.L.stationary(brook_w(ns), 6), 64)
    with pytest.raises(ValueError, match="brook_guard"):
        governed(ns, [cell], horizon=240_000, n_segments=6)


def test_brook_to_brook_switches_allowed():
    ref, port = both(lambda ns: [ns.A.GovernorCell(
        "swt_gp", _switch(ns, "brook_guard", "brook2pl"),
        ns.L.stationary(brook_w(ns), 4), 64)], horizon=30_000, n_segments=4)
    assert_same(ref, port, ["swt_gp"])
    assert port["swt_gp"].forced_aborts == 0
    assert port["swt_gp"].commits > 0


def test_brook_guard_switch_in_recovers():
    ref, port = both(lambda ns: [ns.A.GovernorCell(
        "swt_brook_guard", _switch(ns, "mysql", "brook_guard"),
        ns.L.stationary(brook_w(ns), 6), 64)], horizon=60_000, n_segments=6)
    assert_same(ref, port, ["swt_brook_guard"])
    commits = [s["commits"] for s in port.segments["swt_brook_guard"]]
    assert sum(commits[2:]) > 0, commits
    assert commits[-1] > 0, commits


@pytest.mark.parametrize("ns", [REF, PORT], ids=["ref", "port"])
def test_two_hop_guard_bypass_rejected(ns):
    cell = ns.A.GovernorCell(
        "swt_2hop", _by_segment(ns, ("mysql", "brook_guard", "brook2pl"),
                                "twohop"),
        ns.L.stationary(brook_w(ns), 4), 64)
    with pytest.raises(ValueError, match="unordered-preset"):
        governed(ns, [cell], horizon=60_000, n_segments=4)


def test_rank_rotating_drift_rejected_for_pure_brook():
    for ns in (REF, PORT):
        drift = ns.L.hot_migration(brook_w(ns), 6, n_sites=2, period=1)
        cell = ns.A.GovernorCell("mig_brook", ns.A.FixedPolicy("brook2pl"),
                                 drift, 64)
        with pytest.raises(ValueError, match="rank"):
            governed(ns, [cell], horizon=24_000, n_segments=6)
    ref, port = both(lambda ns: [ns.A.GovernorCell(
        "mig_guard", ns.A.FixedPolicy("brook_guard"),
        ns.L.hot_migration(brook_w(ns), 6, n_sites=2, period=1), 64)],
        horizon=24_000, n_segments=6)
    assert_same(ref, port, ["mig_guard"])
    assert port["mig_guard"].commits > 0


def test_stable_rank_drift_allowed_for_pure_brook():
    ref, port = both(lambda ns: [ns.A.GovernorCell(
        "ramp_brook", ns.A.FixedPolicy("brook2pl"),
        ns.L.skew_ramp(brook_w(ns, zipf_s=0.7), 4, lo=0.3, hi=0.9), 64)],
        horizon=16_000, n_segments=4)
    assert_same(ref, port, ["ramp_brook"])
    r = port["ramp_brook"]
    assert r.forced_aborts == 0 and r.dd_ticks == 0 and r.commits > 0


def test_fixed_brook_guard_no_false_timeouts():
    assert port_adaptive.guard_timeout(36_000, 6) == port_adaptive.GUARD_FLOOR
    ref, port = both(lambda ns: [ns.A.GovernorCell(
        "fx_guard", ns.A.FixedPolicy("brook_guard"),
        ns.L.stationary(brook_w(ns), 6), 64)], horizon=36_000, n_segments=6)
    assert_same(ref, port, ["fx_guard"])
    r = port["fx_guard"]
    assert r.forced_aborts == 0 and r.dd_ticks == 0 and r.commits > 0


def test_brook_guard_last_boundary_switch_recovers():
    n_seg, horizon = 4, 160_000
    assert port_adaptive.guard_timeout(horizon, n_seg) == 20_000
    presets = ("mysql",) * (n_seg - 1) + ("brook_guard",)
    ref, port = both(lambda ns: [ns.A.GovernorCell(
        "swt_late", _by_segment(ns, presets, "lasthop"),
        ns.L.stationary(brook_w(ns), n_seg), 64)],
        horizon=horizon, n_segments=n_seg)
    assert_same(ref, port, ["swt_late"])
    segs = port.segments["swt_late"]
    assert segs[-1]["preset"] == "brook_guard"
    assert segs[-1]["commits"] > 0, [s["commits"] for s in segs]
