"""Port parity for the sweep's lockstep compaction scheduler: the cases of
``tests/test_sweep.py::TestCompaction``. Compacted packs equal per-config
``simulate()`` bit for bit, ``iters`` included, while paying fewer packed
lane-iterations on mixed-density grids."""
import dataclasses

import pytest
import torch

from repro_torch.core.lock import CostModel
from repro_torch.sweep import grid, point, run_sweep, zip_grid
from repro_torch.sweep import runner as R

from test_torch_sweep import HOT, ZIPF, assert_bitexact, reference

HORIZON = 25_000                # test_sweep.py's; cut per case below


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep(points, **kw):
    return run_sweep(points, device="cpu", **kw)


class TestCompaction:
    def test_partial_pack_replicated_pad(self):
        """5 lanes in an 8-wide request: the pack pads to pow2 by
        replicating the last lane; padded copies stay invisible."""
        pts = grid(["mysql", "group", "o2", "bamboo", "o1"], HOT, 8,
                   horizon=10_000)
        res = sweep(pts, chunk_size=8, compact=True)
        assert all(b.compacted for b in res.buckets)
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)

    def test_thread_and_txn_len_padded_lanes(self):
        pts = [point("mysql", ZIPF, 8, horizon=10_000, name="mz2"),
               point("group", dataclasses.replace(ZIPF, txn_len=4), 12,
                     horizon=10_000, name="gz4"),
               point("o2", dataclasses.replace(ZIPF, txn_len=4), 24,
                     horizon=10_000, name="oz4")]
        res = sweep(pts, chunk_size=4, compact=True, thread_bucket="max")
        assert len(res.buckets) == 1
        assert res.buckets[0].pad_len == 4
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)

    def test_drain_lanes_retire_on_quiescence(self):
        """drain lanes end when every thread HALTs: the host retire check
        tracks the condition's live-threads clause."""
        pts = grid(["mysql", "group"], HOT, [4, 8], horizon=12_000,
                   drain=True, name_fmt="d_{protocol}_T{n_threads}")
        res = sweep(pts, chunk_size=4, compact=True)
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)

    def test_aria_barrier_path_staggered_costs(self):
        pts = zip_grid("aria", HOT, [8, 8, 16], horizon=HORIZON,
                       costs=[CostModel(), CostModel(sync_lat=3_000),
                              CostModel(sync_lat=9_000)],
                       name_fmt="aria_T{n_threads}_s{sync_lat}")
        res = sweep(pts, chunk_size=4, compact=True, slice_iters=16)
        for p in pts:
            assert_bitexact(res[p.name], reference(p), p.name)
        assert res.n_repacks >= 1

    def test_mixed_density_cuts_lane_iters_2x(self):
        """Detection-free protocols deadlock-stall on multi-row zipf while
        detection protocols churn; compaction cuts packed lane-iterations
        >= 2x and repacks, bit-identically (horizon cut from 60,000 to
        15,000)."""
        w = dataclasses.replace(ZIPF, n_rows=512)
        mk = lambda pr, t: point(pr, w, t, horizon=15_000,  # noqa: E731
                                 name=f"{pr}_T{t}")
        pts = [mk("o1", 16), mk("mysql", 16),
               mk("o2", 16), mk("o2", 32), mk("o2", 64),
               mk("group", 16), mk("group", 32), mk("group", 64)]
        res_n = sweep(pts, chunk_size=8, compact=False)
        res_c = sweep(pts, chunk_size=8, compact=True)
        for p in pts:
            ref = reference(p)
            assert_bitexact(res_c[p.name], ref, p.name)
            assert_bitexact(res_n[p.name], ref, p.name)
        assert res_c.n_repacks >= 1
        assert res_n.lane_iters >= 2 * res_c.lane_iters, \
            (res_n.lane_iters, res_c.lane_iters)
        log = res_c.buckets[0].repack_log
        assert log and all(len(rec) == 3 for rec in log)

    def test_adaptive_budget_recovers_from_bad_estimate(self, monkeypatch):
        """With ``slice_iters`` unset the budget re-derives from observed
        progress, so an estimate 1000x off costs fewer calls than fixed
        256-iteration slices. At this file's horizon (25,000, cut from
        120,000) the densest lane runs ~1,500 iterations, under 8 of the
        256-iteration floor, so the slice count is cut from 8 to 2 for the
        re-derived budget to clear the floor."""
        w = dataclasses.replace(ZIPF, n_rows=512)
        mk = lambda pr, t: point(pr, w, t, horizon=HORIZON,  # noqa: E731
                                 name=f"{pr}_T{t}")
        pts = [mk("o1", 16), mk("mysql", 16), mk("o2", 16),
               mk("group", 16)]
        monkeypatch.setattr(R, "_est_iters", lambda p: 1.0)
        monkeypatch.setattr(R, "DEFAULT_SLICES", 2)
        res_static = sweep(pts, chunk_size=4, compact=True, slice_iters=256)
        res_adapt = sweep(pts, chunk_size=4, compact=True)
        for p in pts:
            assert res_adapt[p.name].__dict__ == \
                res_static[p.name].__dict__, p.name
        calls_a = sum(b.n_chunks for b in res_adapt.buckets)
        calls_s = sum(b.n_chunks for b in res_static.buckets)
        assert calls_a < calls_s, (calls_a, calls_s)
        assert res_adapt.n_repacks >= 1
        assert res_adapt.lane_iters <= int(1.25 * res_static.lane_iters)
