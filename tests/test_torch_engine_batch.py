"""Port parity for the batched and segmented engine: every lane of the
port's ``_run_batch`` equals the reference's ``_run_batch`` and the port's
own single-lane run, bit for bit in every ``SimState`` leaf; segmented runs
(``_run_seg_dyn`` / ``_run_seg_batch``) equal the reference's in the state
and the ``SegSnapshot``, segment for segment."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.lock import engine as ref_engine
from repro.core.lock import (CostModel as RefCostModel,
                             WorkloadSpec as RefWorkloadSpec)
from repro_torch.core.lock import (EngineConfig, WorkloadSpec, CostModel,
                                   protocol_params, run_sim, extract,
                                   stack_lanes, take_lane)
from repro_torch.core.lock import engine, convert
from repro_torch.core.lock.metrics import extract_globals

T, R = 40, 256


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(proto, kind, n_threads, L=2, horizon=3_000, p_abort=0.0,
             drain=False, hot_base=0, seed=3, max_iters=200_000):
    wl = dict(kind=kind, n_rows=R, txn_len=L, write_ratio=0.7, n_hot=2,
              n_warehouses=2, seed=seed, zipf_s=0.9, hot_base=hot_base)
    run = dict(n_threads=n_threads, horizon=horizon, p_abort=p_abort,
               drain=drain, attrib=True, max_iters=max_iters)
    ref = ref_engine.EngineConfig(
        protocol=ref_engine.protocol_params(proto), costs=RefCostModel(),
        workload=RefWorkloadSpec(**wl), **run)
    port = EngineConfig(protocol=protocol_params(proto), costs=CostModel(),
                        workload=WorkloadSpec(**wl), **run)
    return ref, port


def _pack_cases(kind):
    """Mixed protocols in one pack: p_abort 0 and > 0, a drain lane, padded
    threads and op slots, hot_base != 0, and per-lane horizons."""
    return [_configs("mysql", kind, 40),
            _configs("group", kind, 12, p_abort=0.05, hot_base=7),
            _configs("brook2pl", kind, 33, L=3, horizon=2_500),
            _configs("o2", kind, 40, drain=True, horizon=2_000),
            _configs("bamboo", kind, 20, p_abort=0.05, seed=5),
            _configs("o1", kind, 8, L=1)]


def _ref_pack(cases, L):
    stat = ref_engine.StaticShape(cases[0][0].workload.kind, T, L, R)
    dps = [ref_engine.split_config(r, pad_threads=T, pad_len=L)[1]
           for r, _ in cases]
    stack = lambda xs: jax.tree.map(lambda *x: jnp.stack(x), *xs)  # noqa
    return stat, stack(dps), stack([ref_engine.init_state_dyn(stat, d)
                                    for d in dps])


def _port_pack(cases, L):
    stat = engine.StaticShape(cases[0][1].workload.kind, T, L, R)
    dps = [engine.split_config(p, pad_threads=T, pad_len=L, device="cpu")[1]
           for _, p in cases]
    return stat, dps, stack_lanes(dps), stack_lanes(
        [engine.init_state_dyn(stat, d) for d in dps])


def _leaves(s):
    """(name, numpy leaf) pairs of an engine state or snapshot."""
    if hasattr(s, "th"):
        return [(f"{part}.{f}", np.asarray(getattr(getattr(s, part), f)))
                for part in ("th", "rows", "g")
                for f in getattr(s, part)._fields]
    return [(f, np.asarray(v)) for f, v in zip(s._fields, s)]


def _assert_equal(want, got, what=""):
    """Every leaf: same dtype, same shape, equal values."""
    for (name, a), (_, b) in zip(_leaves(want), _leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {name}")


@pytest.mark.parametrize("kind", ["zipf", "tpcc"])
def test_batch_lanes_equal_reference_and_single(kind):
    cases = _pack_cases(kind)
    stat_r, dps_r, s0_r = _ref_pack(cases, 3)
    want = jax.tree.map(np.asarray, ref_engine._run_batch(stat_r, dps_r,
                                                          s0_r))
    stat, dps, dp_s, s0 = _port_pack(cases, 3)
    got = convert.state_to_numpy(engine._run_batch(stat, dp_s, s0))
    _assert_equal(want, got, kind)
    for i, dp in enumerate(dps):
        single = engine._run_dyn(stat, dp, engine.init_state_dyn(stat, dp))
        lane_i = jax.tree.map(lambda x: x[i], got)
        _assert_equal(convert.state_to_numpy(single), lane_i, f"lane {i}")
    assert (got.g.commits > 0).all()


def test_padding_is_invisible_to_run_sim_metrics():
    """Each lane of a padded pack has the metrics of its unpadded
    ``run_sim`` (the reference's sweep-vs-simulate bar)."""
    cases = _pack_cases("hotspot_update")
    stat, _, dp_s, s0 = _port_pack(cases, 3)
    got = engine._run_batch(stat, dp_s, s0)
    for i, (_, cfg) in enumerate(cases):
        plain = extract(cfg.protocol.name, cfg.n_threads,
                        run_sim(cfg, device="cpu"))
        lane = extract_globals(cfg.protocol.name, cfg.n_threads, got.g,
                               lane=i)
        for f in ("commits", "user_aborts", "forced_aborts", "lock_ops",
                  "iters", "dd_ticks", "tps", "mean_latency_us",
                  "p95_latency_us", "abort_rate", "lock_wait_frac",
                  "cpu_util"):
            assert getattr(lane, f) == getattr(plain, f), (i, f)


def test_batch_from_reference_params_and_states():
    """A reference pack carried across by ``convert`` (params and states
    with a leading lane axis) runs to the reference's result."""
    cases = _pack_cases("zipf")
    stat_r, dps_r, s0_r = _ref_pack(cases, 3)
    mid = ref_engine._run_batch(stat_r, dps_r._replace(
        max_iters=jnp.full((len(cases),), 40, jnp.int32)), s0_r)
    want = jax.tree.map(np.asarray, ref_engine._run_batch(stat_r, dps_r,
                                                          mid))
    dps = convert.params_from_numpy(jax.tree.map(np.asarray, dps_r), "cpu")
    back = convert.params_to_numpy(dps)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, dps_r)),
                    jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = engine._run_batch(engine.StaticShape(*stat_r), dps,
                            convert.state_from_numpy(
                                jax.tree.map(np.asarray, mid), "cpu"))
    _assert_equal(want, convert.state_to_numpy(got))


def test_pause_at_max_iters_and_resume():
    """A pack paused at an iteration budget and resumed replays the same
    steps: every lane, iters included, equals the single-shot pack; a
    frozen lane's iters does not advance."""
    cases = _pack_cases("hotspot_update")
    stat, _, dp_s, s0 = _port_pack(cases, 3)
    whole = convert.state_to_numpy(engine._run_batch(stat, dp_s, s0))
    s = s0
    for cap in (17, 60, 150):
        s = engine._run_batch(stat, dp_s._replace(
            max_iters=np.full(len(cases), cap, np.int32)), s)
        iters = convert.state_to_numpy(s).g.iters
        assert (iters == np.minimum(cap, whole.g.iters)).all(), (cap, iters)
    _assert_equal(whole, convert.state_to_numpy(
        engine._run_batch(stat, dp_s, s)))
    # the host mirror retires exactly the lanes the condition stops
    for i, (_, cfg) in enumerate(cases):
        assert engine.run_finished(cfg, int(whole.g.now[i]),
                                   int(whole.g.iters[i]), whole.th.phase[i])
        assert not engine.run_finished(cfg, 0, 0, whole.th.phase[i] * 0)


def test_seg_batch_equals_reference_segment_for_segment():
    cases = _pack_cases("zipf")
    stat_r, dps_r, s_r = _ref_pack(cases, 3)
    stat, dps, dp_s, s = _port_pack(cases, 3)
    bounds = [[700, 1_000, 450, 900, 1_200, 300],
              [1_600, 2_200, 1_900, 1_500, 2_000, 1_000],
              [3_000, 3_000, 2_500, 7_000_000, 3_000, 3_000]]
    for untils in bounds:
        s_r, snap_r = ref_engine._run_seg_batch(stat_r, dps_r, s_r,
                                                jnp.asarray(untils,
                                                            jnp.int32))
        s, snap = engine._run_seg_batch(stat, dp_s, s,
                                        torch.tensor(untils))
        _assert_equal(jax.tree.map(np.asarray, s_r),
                      convert.state_to_numpy(s), str(untils))
        _assert_equal(jax.tree.map(np.asarray, snap_r),
                      convert.state_to_numpy(snap), str(untils))


@pytest.mark.parametrize("proto,p_abort", [("group", 0.0), ("mysql", 0.05),
                                           ("brook2pl", 0.05)])
def test_seg_dyn_equals_reference_and_single_shot(proto, p_abort):
    ref_cfg, cfg = _configs(proto, "zipf", 24, L=3, horizon=4_000,
                            p_abort=p_abort)
    stat_r, dp_r = ref_engine.split_config(ref_cfg, pad_threads=T)
    stat, dp = engine.split_config(cfg, pad_threads=T, device="cpu")
    s_r = ref_engine.init_state_dyn(stat_r, dp_r)
    s = engine.init_state_dyn(stat, dp)
    for k in range(1, 5):
        s_r, snap_r = ref_engine.run_segment(stat_r, dp_r, s_r, 1_000 * k)
        s, snap = engine.run_segment(stat, dp, s, 1_000 * k)
        _assert_equal(jax.tree.map(np.asarray, s_r),
                      convert.state_to_numpy(s), f"segment {k}")
        _assert_equal(jax.tree.map(np.asarray, snap_r),
                      convert.state_to_numpy(snap), f"snapshot {k}")
    whole = convert.state_to_numpy(
        engine._run_dyn(stat, dp, engine.init_state_dyn(stat, dp)))
    seg = convert.state_to_numpy(s)
    diff = [n for (n, a), (_, b) in zip(_leaves(whole), _leaves(seg))
            if not np.array_equal(a, b)]
    assert diff in ([], ["g.iters"]), diff
    assert 0 <= int(seg.g.iters) - int(whole.g.iters) <= 3


def test_segmented_departs_from_single_shot_as_the_reference_does():
    """The reference's own 4-segment run departs from its single-shot run
    on this lane (ROADMAP queue 3): a cascade pends one iteration while the
    single-shot idle jump reaches the horizon. The port reproduces both
    runs exactly."""
    run = dict(n_threads=8, horizon=4_000, p_abort=0.05)
    ref_cfg = ref_engine.EngineConfig(
        protocol=ref_engine.protocol_params("bamboo"), costs=RefCostModel(),
        workload=RefWorkloadSpec(n_rows=512), **run)
    cfg = EngineConfig(protocol=protocol_params("bamboo"), costs=CostModel(),
                       workload=WorkloadSpec(n_rows=512), **run)
    stat_r, dp_r = ref_engine.split_config(ref_cfg, pad_threads=64)
    stat, dp = engine.split_config(cfg, pad_threads=64, device="cpu")
    s_r = ref_engine.init_state_dyn(stat_r, dp_r)
    s = engine.init_state_dyn(stat, dp)
    for k in range(1, 5):
        s_r, _ = ref_engine.run_segment(stat_r, dp_r, s_r, 1_000 * k)
        s, _ = engine.run_segment(stat, dp, s, 1_000 * k)
    _assert_equal(jax.tree.map(np.asarray, s_r), convert.state_to_numpy(s))
    whole_r = ref_engine._run_dyn(stat_r, dp_r,
                                  ref_engine.init_state_dyn(stat_r, dp_r))
    whole = engine._run_dyn(stat, dp, engine.init_state_dyn(stat, dp))
    _assert_equal(jax.tree.map(np.asarray, whole_r),
                  convert.state_to_numpy(whole))
    # (commits, iters): ROADMAP queue 3's numbers
    assert (int(whole.g.commits), int(whole.g.iters)) == (10, 30)
    assert (int(s.g.commits), int(s.g.iters)) == (19, 70)


def test_q_bucket_matches_reference():
    v = np.arange(-3, 2**12 + 1, dtype=np.int32)
    want = np.asarray(ref_engine._q_bucket(jnp.asarray(v)))
    thr = torch.from_numpy(engine.Q_THRESHOLDS)
    got = engine._q_bucket(torch.from_numpy(v), thr).numpy()
    np.testing.assert_array_equal(got, want)


def test_stack_and_take_lane_round_trip():
    _, cfg = _configs("group", "zipf", 12, p_abort=0.05)
    _, dp = engine.split_config(cfg, device="cpu")
    dps = stack_lanes([dp, dp._replace(horizon=77, dd_coeff=0.5)])
    assert dps.horizon.dtype == np.int32 and dps.dd_coeff.dtype == np.float32
    assert dps.has_detection.dtype == np.bool_
    assert dps.wl.zcdf.shape == (2, R) and dps.txn_cap.shape == (2, 12)
    one = take_lane(dps, 1)
    assert one.horizon == 77 and one.dd_coeff == 0.5 and one.wl.seed == 3
    assert isinstance(one.has_detection, bool)
