"""Port parity for the sweep subsystem (``repro_torch.sweep``): the cases of
``tests/test_sweep.py``'s ``TestParity``, ``TestGridBuilders`` and
``TestStore`` at that file's sizes or smaller (``TestCompaction`` is in
``test_torch_sweep_compaction.py``), plus the port against the reference
directly — ``run_sweep`` metrics ``==``-equal to ``repro.sweep.run_sweep``'s
on both execution paths (``iters`` included), and store documents that
each package loads from the other.

Cases of ``tests/test_sweep.py`` with no counterpart on one card:

* ``TestLaneSharding::test_nondividing_lane_count_pads_and_engages`` — it
  shards the lane axis over a 3-device host mesh. Its counterpart is in
  ``test_torch_sweep_shards.py`` (three CPU shards, one worker process
  each); on one device ``run_sweep(shard=...)`` does nothing, which is the
  reference's own single-device behaviour (checked below).
* ``TestCompileAccounting::test_64_grid_one_compile_per_bucket``,
  ``::test_compacted_width_ladder_bounds_executables`` and
  ``::test_chunk_reuse_second_sweep_compiles_nothing`` — they count JAX's
  jit cache. The port is eager and captures no CUDA graphs, so it compiles
  nothing: ``n_compiles`` is 0 on every sweep (checked below).
"""
import dataclasses
import json
import os
import warnings

import pytest
import torch

from repro.core.lock import (CostModel as RefCostModel,
                             WorkloadSpec as RefWorkloadSpec)
from repro import sweep as ref_sweep
from repro.sweep.grid import SweepPoint as RefSweepPoint
from repro_torch.core.lock import (CostModel, WorkloadSpec, extract,
                                   extract_aria, simulate, simulate_aria)
from repro_torch.sweep import (expand, grid, load_results, point, run_sweep,
                               save_results, summarize, zip_grid)
from repro_torch.sweep import runner as R

HOT = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=512)
ZIPF = WorkloadSpec(kind="zipf", txn_len=2, n_rows=256, zipf_s=0.9)
HORIZON = 8_000                 # cut from test_sweep.py's 25,000

INT_FIELDS = ("commits", "user_aborts", "forced_aborts", "lock_ops",
              "iters", "dd_ticks")
FLOAT_FIELDS = ("tps", "mean_latency_us", "p95_latency_us", "abort_rate",
                "lock_wait_frac", "cpu_util")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep(points, **kw):
    return run_sweep(points, device="cpu", **kw)


def reference(p):
    """Per-config result via the port's plain simulate() path."""
    if p.protocol == "aria":
        s = simulate_aria(p.workload, p.n_threads, costs=p.costs,
                          horizon=p.horizon, device="cpu")
        return extract_aria(p.n_threads, s)
    s = simulate(p.protocol, p.workload, p.n_threads, costs=p.costs,
                 horizon=p.horizon, p_abort=p.p_abort, drain=p.drain,
                 device="cpu", **p.over())
    return extract(p.protocol, p.n_threads, s)


def assert_bitexact(r_sweep, r_ref, name):
    for f in INT_FIELDS + FLOAT_FIELDS:
        assert getattr(r_sweep, f) == getattr(r_ref, f), (name, f)


def _ref_points(pts):
    """The same points built with the reference's types."""
    return [RefSweepPoint(
        **{**dataclasses.asdict(p),
           "workload": RefWorkloadSpec(**dataclasses.asdict(p.workload)),
           "costs": RefCostModel(**dataclasses.asdict(p.costs))})
        for p in pts]


class TestParity:
    def test_packed_grid_matches_simulate_bitexact(self):
        """Heterogeneous protocols/threads/p_abort in packs of 4: every
        lane equals its per-config run bit for bit (threads padded to the
        64-floor bucket)."""
        pts = grid(["mysql", "group", "bamboo"], HOT, [8, 12],
                   horizon=HORIZON, p_abort=[0.0, 0.1],
                   name_fmt="{protocol}_T{n_threads}_p{p_abort}")
        res = sweep(pts, chunk_size=4)
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)

    def test_heterogeneous_txn_len_padding(self):
        pts = [point("group", ZIPF, 8, horizon=HORIZON, name="zl2"),
               point("group", dataclasses.replace(ZIPF, txn_len=4), 8,
                     horizon=HORIZON, name="zl4")]
        res = sweep(pts, chunk_size=2)
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)

    def test_max_bucket_pads_txn_len(self):
        pts = [point("mysql", ZIPF, 8, horizon=HORIZON, name="mx2"),
               point("mysql", dataclasses.replace(ZIPF, txn_len=4), 12,
                     horizon=HORIZON, name="mx4")]
        res = sweep(pts, chunk_size=2, thread_bucket="max")
        assert len(res.buckets) == 1
        assert res.buckets[0].pad_len == 4
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)

    def test_aria_lanes_match(self):
        pts = grid("aria", HOT, [8, 16], horizon=HORIZON)
        res = sweep(pts, chunk_size=2)
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)

    def test_proto_override_flows_through(self):
        pts = [point("group", HOT, 16, horizon=HORIZON, name="gc_off",
                     group_commit=False)]
        res = sweep(pts)
        assert_bitexact(res["gc_off"], reference(pts[0]), "gc_off")

    def test_aria_rejects_unsupported_params(self):
        pts = [point("aria", HOT, 8, horizon=HORIZON, p_abort=0.1,
                     name="aria_p0.1")]
        with pytest.raises(ValueError, match="aria does not support"):
            sweep(pts)

    def test_unknown_protocol_fails_loudly(self):
        pts = [point("br00k2pl", HOT, 8, horizon=1000, name="b2pl")]
        with pytest.raises(ValueError, match="unknown protocol"):
            sweep(pts)

    def test_brook2pl_lanes_match_simulate_bitexact(self):
        w = dataclasses.replace(ZIPF, n_rows=251)
        pts = grid(["brook2pl", "mysql"], w, [8, 12], horizon=4_000,
                   p_abort=[0.0, 0.1],
                   name_fmt="{protocol}_T{n_threads}_p{p_abort}")
        res = sweep(pts, chunk_size=4)
        assert len(res.buckets) == 1
        assert res.n_compiles == 0
        for p in pts:
            r = res[p.name]
            assert_bitexact(r, reference(p), p.name)
            if p.protocol == "brook2pl":
                assert r.forced_aborts == 0 and r.dd_ticks == 0, p.name

    def test_est_iters_covers_brook2pl_without_warning(self):
        R._EST_WARNED.clear()
        pts = grid(["brook2pl"], HOT, [8, 64], horizon=HORIZON)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ests = [R._est_iters(p) for p in pts]
        assert all(e > 0 for e in ests)
        assert not w, [str(x.message) for x in w]
        assert ests[1] >= ests[0] * 0.99

    def test_est_iters_ref_model_gap_warns_once_and_falls_back(self,
                                                               monkeypatch):
        import repro_torch.core.lock.ref_engine as ref

        def boom(*a, **k):
            raise ValueError("no chain model for this knob combo")

        monkeypatch.setattr(ref, "predicted_tps", boom)
        R._EST_WARNED.clear()
        pts = grid(["mysql", "o2"], HOT, [8, 12], horizon=HORIZON)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ests = [R._est_iters(p) for p in pts]
        assert all(e > 0 for e in ests)
        assert len([x for x in w if x.category is RuntimeWarning]) == 2

        def bug(*a, **k):
            raise TypeError("a real bug")

        monkeypatch.setattr(ref, "predicted_tps", bug)
        R._EST_WARNED.clear()
        with pytest.raises(TypeError, match="a real bug"):
            R._est_iters(pts[0])

    @pytest.mark.parametrize("compact", [True, False])
    def test_equals_the_reference_sweep(self, compact):
        """The port's run_sweep against ``repro.sweep.run_sweep`` on the
        same points: every metric ``==``-equal, and the same accounting."""
        pts = (grid(["mysql", "group", "brook2pl"], ZIPF, [8, 24],
                    horizon=5_000, p_abort=[0.0, 0.05],
                    name_fmt="{protocol}_T{n_threads}_p{p_abort}")
               + grid("aria", ZIPF, [8, 24], horizon=5_000)
               + [point("bamboo", ZIPF, 12, horizon=3_000, drain=True,
                        name="drain_bamboo")])
        want = ref_sweep.run_sweep(_ref_points(pts), chunk_size=4,
                                   compact=compact)
        got = sweep(pts, chunk_size=4, compact=compact)
        for p in pts:
            assert got[p.name].__dict__ == want[p.name].__dict__, p.name
        assert got.lane_iters == want.lane_iters
        assert got.n_repacks == want.n_repacks
        assert [(b.n_chunks, b.repack_log) for b in got.buckets] == \
            [(b.n_chunks, b.repack_log) for b in want.buckets]
        assert got.n_compiles == 0

    def test_shard_is_inert_on_one_device(self):
        pts = grid(["mysql", "group"], HOT, 8, horizon=10_000)
        a = sweep(pts, chunk_size=2, shard=True)
        b = sweep(pts, chunk_size=2, shard=False)
        for p in pts:
            assert a[p.name].__dict__ == b[p.name].__dict__

    def test_default_width_and_device(self, monkeypatch):
        assert R._auto_chunk(torch.device("cpu")) == 1
        assert R._auto_chunk(torch.device("cuda")) == R.CUDA_CHUNK
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_sweep(grid("mysql", HOT, 8, horizon=1000))


class TestGridBuilders:
    def test_cartesian_counts_and_names(self):
        pts = grid(["mysql", "o2"], {"hot": HOT}, [8, 16], horizon=1000,
                   p_abort=[0.0, 0.1],
                   name_fmt="{protocol}_{workload}_T{n_threads}_p{p_abort}")
        assert len(pts) == 8
        assert len({p.name for p in pts}) == 8
        assert pts[0].name.startswith(("mysql_hot", "o2_hot"))
        # the same names and fields as the reference's builder
        want = ref_sweep.grid(
            ["mysql", "o2"], {"hot": RefWorkloadSpec(
                **dataclasses.asdict(HOT))}, [8, 16], horizon=1000,
            p_abort=[0.0, 0.1],
            name_fmt="{protocol}_{workload}_T{n_threads}_p{p_abort}")
        assert [dataclasses.asdict(p) for p in pts] == \
            [dataclasses.asdict(p) for p in want]

    def test_zip_grid_pairs_and_broadcasts(self):
        pts = zip_grid(["mysql", "o2", "group"], HOT, 8, horizon=1000,
                       costs=[CostModel(sync_lat=s) for s in (0, 10, 20)])
        assert len(pts) == 3
        assert [p.costs.sync_lat for p in pts] == [0, 10, 20]
        with pytest.raises(ValueError):
            zip_grid(["mysql", "o2"], HOT, [1, 2, 3], horizon=1000)

    def test_expand_workload_fields(self):
        ws = expand(ZIPF, tag_fmt="sf{zipf_s}", zipf_s=[0.7, 0.99])
        assert [t for t, _ in ws] == ["sf0.7", "sf0.99"]
        assert ws[1][1].zipf_s == 0.99
        ws2 = expand(ZIPF, zipf_s=[0.7, 0.99], txn_len=[2, 4])
        want = ref_sweep.expand(RefWorkloadSpec(**dataclasses.asdict(ZIPF)),
                                zipf_s=[0.7, 0.99], txn_len=[2, 4])
        assert [(t, dataclasses.asdict(s)) for t, s in ws2] == \
            [(t, dataclasses.asdict(s)) for t, s in want]

    def test_duplicate_names_rejected(self):
        pts = grid("mysql", HOT, 8, horizon=1000) * 2
        with pytest.raises(ValueError, match="duplicate"):
            sweep(pts)


class TestStore:
    PTS = (grid(["mysql", "o2"], HOT, 8, horizon=HORIZON)
           + grid("aria", HOT, 8, horizon=HORIZON))

    def test_roundtrip(self, tmp_path):
        res = sweep(self.PTS)
        path = os.path.join(tmp_path, "sweep.json")
        save_results(path, res, meta={"tag": "t"})
        doc = load_results(path)
        assert doc["schema"] == "repro.sweep/v4"
        assert doc["meta"]["tag"] == "t"
        assert doc["n_points"] == 3 and doc["n_compiles"] == 0
        names = [r["name"] for r in doc["points"]]
        assert names == [p.name for p in self.PTS]
        rec = doc["points"][0]
        assert rec["metrics"]["commits"] == res[rec["name"]].commits
        assert rec["workload"]["kind"] == "hotspot_update"
        rows = summarize(res)
        assert len(rows) == 3 and rows[0].startswith(self.PTS[0].name + ",")

    def test_documents_load_across_packages(self, tmp_path):
        """The port's document loads with ``repro.sweep.store`` and the
        reference's with the port's, and they match point for point."""
        mine = save_results(os.path.join(tmp_path, "port.json"),
                            sweep(self.PTS))
        theirs = ref_sweep.save_results(
            os.path.join(tmp_path, "ref.json"),
            ref_sweep.run_sweep(_ref_points(self.PTS)))
        a = ref_sweep.load_results(mine)
        b = load_results(theirs)
        assert a["schema"] == b["schema"] == "repro.sweep/v4"
        drop = ("wall_us",)
        strip = lambda recs: [{k: v for k, v in r.items()  # noqa: E731
                               if k not in drop} for r in recs]
        assert strip(a["points"]) == strip(b["points"])
        assert [{k: v for k, v in bk.items() if k != "wall_s"}
                for bk in a["buckets"]] == \
            [{k: v for k, v in bk.items() if k != "wall_s"}
             for bk in b["buckets"]]
        assert summarize(sweep(self.PTS))[1].split(",")[2:] == \
            ref_sweep.summarize(ref_sweep.run_sweep(
                _ref_points(self.PTS)))[1].split(",")[2:]

    def test_load_rejects_foreign_json(self, tmp_path):
        path = os.path.join(tmp_path, "x.json")
        with open(path, "w") as f:
            json.dump({"hello": 1}, f)
        with pytest.raises(ValueError):
            load_results(path)
