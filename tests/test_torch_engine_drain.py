"""Port parity, continued: drain runs, a run resumed from a reference state,
the latency-histogram buckets, metrics extraction and the analytic oracle
(the matrix of plain runs is in test_torch_engine.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.lock import engine as ref_engine
from repro.core.lock import (CostModel as RefCostModel,
                             WorkloadSpec as RefWorkloadSpec)
from repro_torch.core.lock import (EngineConfig, WorkloadSpec, CostModel,
                                   protocol_params, run_sim, extract, HALT)
from repro_torch.core.lock import engine, convert

PROTOS = ["mysql", "o1", "o2", "group", "bamboo", "brook2pl"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(proto, kind, T=40, R=128, L=3, horizon=4_000, p_abort=0.0,
             drain=False, attrib=True, seed=3):
    wl = dict(kind=kind, n_rows=R, txn_len=L, write_ratio=0.7, n_hot=2,
              n_warehouses=2, seed=seed, zipf_s=0.9)
    run = dict(n_threads=T, horizon=horizon, p_abort=p_abort, drain=drain,
               attrib=attrib, max_iters=200_000)
    ref = ref_engine.EngineConfig(
        protocol=ref_engine.protocol_params(proto), costs=RefCostModel(),
        workload=RefWorkloadSpec(**wl), **run)
    port = EngineConfig(protocol=protocol_params(proto), costs=CostModel(),
                        workload=WorkloadSpec(**wl), **run)
    return ref, port


def _ref_run(cfg):
    stat, dp = ref_engine.split_config(cfg)
    s = ref_engine._run_dyn(stat, dp, ref_engine.init_state_dyn(stat, dp))
    return jax.tree.map(np.asarray, s)


def _assert_states_equal(ref, port):
    """Every leaf: same dtype, same shape, equal values."""
    port = convert.state_to_numpy(port)
    for part in ("th", "rows", "g"):
        a, b = getattr(ref, part), getattr(port, part)
        assert a._fields == b._fields
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (part, f)
            np.testing.assert_array_equal(y, x, err_msg=f"{part}.{f}")


@pytest.mark.parametrize("proto", PROTOS)
def test_drain_bit_equal_and_invariants(proto):
    ref_cfg, cfg = _configs(proto, "fit", T=24, R=96, L=2, horizon=3_000,
                            p_abort=0.1, drain=True)
    want = _ref_run(ref_cfg)
    got = run_sim(cfg, device="cpu")
    _assert_states_equal(want, got)
    # the reference's drain invariants: quiesced, no ticket leak, no lost
    # or dirty updates
    assert bool((got.th.phase == HALT).all())
    assert bool((got.th.ticket < 0).all())
    assert int((got.rows.applied_val - got.rows.committed_val).abs().sum()) \
        == 0
    assert int(got.g.commits) > 0


@pytest.mark.parametrize("proto", ["group", "mysql", "brook2pl"])
def test_resume_from_reference_state(proto):
    """A mid-run reference state, carried across by ``convert``, continues
    in the port exactly as the reference continues it."""
    ref_cfg, _ = _configs(proto, "hotspot_update", horizon=5_000,
                          p_abort=0.05)
    stat, dp = ref_engine.split_config(ref_cfg)
    mid, _ = ref_engine.run_segment(stat, dp,
                                    ref_engine.init_state_dyn(stat, dp),
                                    2_000)
    want = jax.tree.map(np.asarray, ref_engine._run_dyn(stat, dp, mid))
    mid_np = jax.tree.map(np.asarray, mid)
    pdp = convert.params_from_numpy(jax.tree.map(np.asarray, dp), "cpu")
    pstat = engine.StaticShape(*stat)
    got = engine._run_dyn(pstat, pdp, convert.state_from_numpy(mid_np, "cpu"))
    _assert_states_equal(want, got)
    # and the parameters survive the round trip
    back = convert.params_to_numpy(pdp)
    for f in ref_engine.DynParams._fields:
        if f == "wl":
            continue
        x, y = np.asarray(getattr(dp, f)), getattr(back, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_hist_bucket_matches_reference():
    lat = np.arange(0, 2**22, dtype=np.int32)
    want = np.asarray(ref_engine._hist_bucket(jnp.asarray(lat)))
    thr = torch.from_numpy(engine.HIST_THRESHOLDS)
    got = engine._hist_bucket(torch.from_numpy(lat), thr).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_matches_reference():
    ref_cfg, cfg = _configs("group", "hotspot_update", horizon=8_000)
    want_state = _ref_run(ref_cfg)
    from repro.core.lock.metrics import extract as ref_extract
    want = ref_extract("group", cfg.n_threads, want_state)
    got = extract("group", cfg.n_threads, run_sim(cfg, device="cpu"))
    assert got.__dict__ == want.__dict__


def test_oracle_predicted_tps_equal():
    from repro.core.lock.ref_engine import predicted_tps as ref_predicted
    from repro_torch.core.lock.ref_engine import predicted_tps
    for proto in PROTOS:
        for T in (1, 128):
            assert predicted_tps(proto, T, CostModel()) == \
                ref_predicted(proto, T, RefCostModel())
