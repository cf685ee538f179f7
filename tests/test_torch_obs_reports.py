"""Port parity of the observability reports (``repro_torch.obs``: export,
breakdown, hotspot, blame) against ``repro.obs`` on the CPU.

The reports are host code over a run's events and accumulators, so each is
fed one run of each package from the same inputs and must produce the same
document or text:

- a contended mysql zipf trace (T=24, 20,000 ticks; tests/test_obs.py and
  tests/test_hotspot.py use 60,000, cut for the file's time):
  ``to_chrome_trace`` JSON with and without hotspot lanes,
  ``wait_profile``, ``blame_matrix``, ``critical_path``, ``blame_table``,
  ``hotspot_lane_events``; a capacity-truncated trace's warnings;
- the six protocols with attribution on (T=24, 10,000 ticks):
  ``breakdown_table``, ``breakdown_row``, ``hotspot_summary`` and
  ``hotspot_report`` with the zipf ground truth, tick and contention
  conservation;
- tick and contention conservation over every segment window of a
  segmented run (tests/test_hotspot.py's at 20,000 ticks, cut from 60,000)
  and of governed segments (tests/test_obs.py's, 48,000 ticks);
- the blame fixtures of tests/test_hotspot.py::TestBlame on synthetic
  events.

tests/test_hotspot.py's flag-is-traced (no recompile) test has no
counterpart: eager torch compiles nothing.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core.lock import WorkloadSpec as RefWorkloadSpec
from repro.core.lock import extract as ref_extract, simulate as ref_simulate
from repro_torch import obs
from repro_torch.adaptive import FixedPolicy, GovernorCell, run_governed
from repro_torch.core.lock import (CostModel, EngineConfig, WorkloadSpec,
                                   engine, extract, hot_migration,
                                   protocol_params, simulate)
from repro_torch.core.lock.metrics import delta_globals
from repro_torch.obs.export import _wait_spans
from repro_torch.sweep.runner import MIN_T_BUCKET, _pow2ceil

ZIPF = dict(kind="zipf", txn_len=4, n_rows=512, zipf_s=0.9)
PROTOS = ["mysql", "o1", "o2", "group", "bamboo", "brook2pl"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traces():
    """One mysql zipf trace of each package and the run's end tick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    run = dict(horizon=20_000, cap=65_536)
    s, tb = obs.simulate_traced("mysql", WorkloadSpec(**ZIPF), 24,
                                device="cpu", **run)
    rs, rtb = ref_obs.simulate_traced("mysql", RefWorkloadSpec(**ZIPF), 24,
                                      **run)
    torch.set_num_threads(n)
    assert int(s.g.now) == int(rs.g.now)
    return obs.events_host(tb), ref_obs.events_host(rtb), int(s.g.now)


def test_chrome_trace_and_wait_profile_equal(traces):
    ev, ref_ev, end = traces
    assert ev["n"] > 0 and np.sum(ev["ev"] == obs.EV_VICTIM) >= 1
    for lanes in (0, 4):
        doc = obs.to_chrome_trace(ev, label="t", end=end,
                                  hotspot_lanes=lanes)
        want = ref_obs.to_chrome_trace(ref_ev, label="t", end=end,
                                       hotspot_lanes=lanes)
        assert json.dumps(doc) == json.dumps(want)
        doc2 = json.loads(json.dumps(doc))
        assert doc2["otherData"]["dropped"] == 0
        for e in doc2["traceEvents"]:
            assert e["ph"] in ("X", "i", "M", "C")
            if e["ph"] == "X":
                assert e["dur"] >= 0 and e["ts"] >= 0
    assert obs.wait_profile(ev, top_k=5) == ref_obs.wait_profile(ref_ev,
                                                                 top_k=5)
    assert obs.hotspot_lane_events(ev, top_k=2, end=end) == \
        ref_obs.hotspot_lane_events(ref_ev, top_k=2, end=end)
    n_spans = sum(1 for _ in _wait_spans(ev))
    assert n_spans == int(np.sum(ev["ev"] == obs.EV_WAIT_ENTER))


def test_blame_equal(traces):
    ev, ref_ev, end = traces
    b, want = obs.blame_matrix(ev, end=end), ref_obs.blame_matrix(ref_ev,
                                                                  end=end)
    assert dataclasses.asdict(b) == dataclasses.asdict(want)
    assert b.n_spans > 0 and b.per_txn
    assert obs.critical_path(ev, end=end) == \
        ref_obs.critical_path(ref_ev, end=end)
    assert obs.blame_table(ev, end=end) == ref_obs.blame_table(ref_ev,
                                                               end=end)
    # per-record blame is the wait profile's queued ticks per row
    per_row = {}
    for _tid, row, t0, t1, _e in _wait_spans(ev, end=end):
        per_row[row] = per_row.get(row, 0) + (t1 - t0)
    assert b.per_record == per_row


def test_truncated_trace_reports_warn_alike():
    run = dict(horizon=8_000, cap=64, alloc=4096)
    _, tb = obs.simulate_traced("mysql", WorkloadSpec(**ZIPF), 24,
                                device="cpu", **run)
    _, rtb = ref_obs.simulate_traced("mysql", RefWorkloadSpec(**ZIPF), 24,
                                     **run)
    assert "WARNING" in obs.wait_profile(tb)
    assert obs.wait_profile(tb) == ref_obs.wait_profile(rtb)
    assert obs.blame_table(tb) == ref_obs.blame_table(rtb)


@pytest.fixture(scope="module")
def runs():
    """The six protocols with attribution on, in each package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    run = dict(n_threads=24, horizon=10_000, attrib=True)
    port = {p: simulate(p, WorkloadSpec(**ZIPF), device="cpu", **run)
            for p in PROTOS}
    ref = {p: ref_simulate(p, RefWorkloadSpec(**ZIPF), **run)
           for p in PROTOS}
    torch.set_num_threads(n)
    return port, ref


def test_breakdown_reports_equal(runs):
    port, ref = runs
    res = {p: extract(p, 24, s) for p, s in port.items()}
    want = {p: ref_extract(p, 24, s) for p, s in ref.items()}
    assert obs.breakdown_table(res) == ref_obs.breakdown_table(want)
    for p in PROTOS:
        assert obs.breakdown_row(res[p].breakdown) == \
            ref_obs.breakdown_row(want[p].breakdown)
        assert obs.check_conservation(port[p], 24) == \
            ref_obs.check_conservation(ref[p], 24)
        assert obs.tick_sum(port[p]) == 24 * int(port[p].g.now)
        assert sum(obs.fractions(res[p].breakdown).values()) == \
            pytest.approx(1.0)


def test_hotspot_reports_equal(runs):
    port, ref = runs
    spec, ref_spec = WorkloadSpec(**ZIPF), RefWorkloadSpec(**ZIPF)
    for p in PROTOS:
        s, rs = port[p], ref[p]
        assert obs.check_ca_conservation(s) == \
            ref_obs.check_ca_conservation(rs)
        assert obs.hotspot_summary(s, spec) == \
            ref_obs.hotspot_summary(rs, ref_spec)
        assert obs.hotspot_report(s, spec, top_k=5) == \
            ref_obs.hotspot_report(rs, ref_spec, top_k=5)
        np.testing.assert_array_equal(obs.wait_share(s),
                                      ref_obs.wait_share(rs))
        assert obs.top_share(s, 3) == ref_obs.top_share(rs, 3)
    h = obs.hotspot_summary(port["mysql"], spec)
    assert h["wait_ticks"] > 0 and 0 < h["gini_zipf"] < 1
    assert obs.gini(np.ones(10)) == pytest.approx(0.0, abs=1e-9)
    assert obs.gini(np.zeros(4)) == 0.0


def test_conservation_over_segment_windows():
    """Every delta window of a segmented run conserves ticks and the
    contention accumulator, and the windows add up to the run."""
    cfg = EngineConfig(protocol=protocol_params("mysql"), costs=CostModel(),
                       workload=WorkloadSpec(**ZIPF), n_threads=24,
                       horizon=20_000, attrib=True)
    stat, dp = engine.split_config(cfg, device="cpu")
    s = engine.init_state_dyn(stat, dp)
    g_prev = s.g
    seen = 0
    for k in range(4):
        s, _snap = engine.run_segment(stat, dp, s, 20_000 * (k + 1) // 4)
        w = delta_globals(g_prev, s.g)
        obs.check_conservation(w, 24)
        seen += obs.check_ca_conservation(w)
        g_prev = s.g
    assert seen == obs.check_ca_conservation(s) > 0


def test_governed_segments_conserve():
    drift = hot_migration(WorkloadSpec(**ZIPF), 4, n_sites=4, period=1)
    res = run_governed([GovernorCell("c", FixedPolicy("mysql"), drift, 12)],
                       horizon=48_000, n_segments=4, device="cpu")
    segs = res.segments["c"]
    assert len(segs) == 4
    pad_t = _pow2ceil(12, MIN_T_BUCKET)
    for seg in segs:
        window = seg["t1"] - seg["t0"]
        assert window > 0
        assert sum(seg["breakdown"].values()) == pad_t * window
        assert sum(seg["wait_hist"]) == ZIPF["n_rows"]
        assert sum(seg["occ_hist"]) == seg["n_hot"]


def _ev(rows):
    """Synthetic event table from (ts, tid, row, ev) tuples."""
    ts, tid, row, ev = (np.asarray(c, dtype=np.int32) for c in zip(*rows))
    return {"ts": ts, "tid": tid, "row": row, "ev": ev,
            "n": len(rows), "dropped": 0, "cap": 4096}


GRANT, WAIT, COMMIT, ABORT = (obs.EV_GRANT, obs.EV_WAIT_ENTER,
                              obs.EV_COMMIT, obs.EV_ABORT)


@pytest.mark.parametrize("rows,end", [
    # t0 holds row 5 over [0, 10); t1 waits [2, 10) then is granted
    ([(0, 0, 5, GRANT), (2, 1, 5, WAIT), (10, 0, 5, obs.EV_RELEASE),
      (10, 1, 5, GRANT), (12, 1, -1, COMMIT), (15, 0, -1, COMMIT)], 20),
    # t0's second attempt holds the row while t1 waits
    ([(0, 0, 5, GRANT), (3, 0, -1, ABORT), (4, 0, 5, GRANT),
      (5, 1, 5, WAIT), (9, 0, -1, COMMIT), (9, 1, 5, GRANT),
      (11, 1, -1, COMMIT)], 20),
    # nobody recorded holding row 7
    ([(2, 1, 7, WAIT), (10, 1, 7, GRANT), (12, 1, -1, COMMIT)], 20),
    # t2 waits on t1 (row 3), t1 waits on t0 (row 5)
    ([(0, 0, 5, GRANT), (0, 1, 3, GRANT), (1, 2, 3, WAIT), (2, 1, 5, WAIT),
      (10, 0, -1, COMMIT), (10, 1, 5, GRANT), (12, 1, -1, COMMIT),
      (12, 2, 3, GRANT), (14, 2, -1, COMMIT)], 20),
], ids=["single_blocker", "attempt_after_abort", "unattributed", "chain"])
def test_blame_fixtures_equal(rows, end):
    ev = _ev(rows)
    b = obs.blame_matrix(ev, end=end)
    assert dataclasses.asdict(b) == \
        dataclasses.asdict(ref_obs.blame_matrix(ev, end=end))
    assert obs.critical_path(ev, end=end) == \
        ref_obs.critical_path(ev, end=end)
    assert obs.blame_table(ev, end=end) == ref_obs.blame_table(ev, end=end)
