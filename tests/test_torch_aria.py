"""Port parity for Aria: every ``AriaState`` leaf of the port equals the
reference's (single configs, packs of lanes with padded threads and op
slots, segmented runs), and ``tests/test_lock_engine.py::TestAria``'s
orderings hold at a reduced size."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.lock import aria as ref_aria
from repro.core.lock import (CostModel as RefCostModel,
                             WorkloadSpec as RefWorkloadSpec)
from repro_torch.core.lock import (WorkloadSpec, CostModel, StaticShape,
                                   simulate_aria, extract_aria, stack_lanes)
from repro_torch.core.lock import aria, convert

R = 512


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kind="zipf", T=12, L=2, horizon=20_000, seed=0, **costs):
    wl = dict(kind=kind, n_rows=R, txn_len=L, zipf_s=0.9, seed=seed,
              write_ratio=0.7)
    ref = ref_aria.AriaConfig(RefWorkloadSpec(**wl), RefCostModel(**costs),
                              T, horizon)
    port = aria.AriaConfig(WorkloadSpec(**wl), CostModel(**costs), T,
                           horizon)
    return ref, port


def _assert_equal(want, got, what=""):
    got = convert.state_to_numpy(got)
    for f, a, b in zip(want._fields, want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {f}")


@pytest.mark.parametrize("kind,T,L", [("zipf", 12, 2),
                                      ("hotspot_update", 64, 1),
                                      ("tpcc", 40, 4)])
def test_simulate_aria_equals_reference(kind, T, L):
    ref_cfg, cfg = _cfgs(kind, T, L)
    want = ref_aria.simulate_aria(ref_cfg.workload, T, ref_cfg.costs,
                                  ref_cfg.horizon)
    got = simulate_aria(cfg.workload, T, cfg.costs, cfg.horizon,
                        device="cpu")
    _assert_equal(jax.tree.map(np.asarray, want), got, kind)
    assert extract_aria(T, got).__dict__ == \
        ref_aria.extract_aria(T, want).__dict__


def _packs():
    """Lanes with other threads, txn lengths, costs, horizons and seeds,
    padded to T=40 and L=3."""
    return [_cfgs(T=12, L=2), _cfgs(T=40, L=3, seed=4, sync_lat=300,
                                    horizon=15_000),
            _cfgs(T=5, L=1, op_exec=80, horizon=9_000),
            _cfgs(T=33, L=3, commit_base=250, seed=2)]


def test_batch_lanes_equal_reference():
    cases = _packs()
    stat_r = ref_aria.StaticShape("zipf", 40, 3, R)
    dps_r = jax.tree.map(lambda *x: jnp.stack(x), *[
        ref_aria.split_aria(r, 40, 3)[1] for r, _ in cases])
    want = jax.tree.map(np.asarray, ref_aria._run_batch(stat_r, dps_r))
    stat = StaticShape(*stat_r)
    dps = [aria.split_aria(p, 40, 3, device="cpu")[1] for _, p in cases]
    got = aria._run_batch(stat, stack_lanes(dps))
    _assert_equal(want, got)
    for i, dp in enumerate(dps):
        _assert_equal(jax.tree.map(lambda x: x[i], want),
                      aria._run_dyn(stat, dp), f"lane {i}")
    # reference params carried across with their lane axis
    got2 = aria._run_batch(stat, convert.params_from_numpy(
        jax.tree.map(np.asarray, dps_r), "cpu", cls=aria.AriaDyn))
    _assert_equal(want, got2)


def test_segmented_equals_reference_and_single_shot():
    cases = _packs()
    stat_r = ref_aria.StaticShape("zipf", 40, 3, R)
    dps_r = jax.tree.map(lambda *x: jnp.stack(x), *[
        ref_aria.split_aria(r, 40, 3)[1] for r, _ in cases])
    stat = StaticShape(*stat_r)
    dps = stack_lanes([aria.split_aria(p, 40, 3, device="cpu")[1]
                       for _, p in cases])
    s_r = jax.tree.map(lambda *x: jnp.stack(x), *[
        ref_aria.init_aria_state(stat_r)] * len(cases))
    s = stack_lanes([aria.init_aria_state(stat, "cpu")] * len(cases))
    for untils in ([3_000, 1_000, 2_500, 7_000], [9_000, 9_000, 9_000,
                                                  9_000],
                   [20_000] * 4):
        s_r = ref_aria._run_seg_batch(stat_r, dps_r, s_r,
                                      jnp.asarray(untils, jnp.int32))
        s = aria._run_seg_batch(stat, dps, s, untils)
        _assert_equal(jax.tree.map(np.asarray, s_r), s, str(untils))
    _assert_equal(jax.tree.map(np.asarray,
                               ref_aria._run_batch(stat_r, dps_r)), s)
    # one lane through _run_seg_dyn, resumed from a reference state
    dp = aria.split_aria(cases[1][1], 40, 3, device="cpu")[1]
    mid_r = ref_aria._run_seg_dyn(stat_r, jax.tree.map(lambda x: x[1],
                                                       dps_r),
                                  ref_aria.init_aria_state(stat_r),
                                  jnp.int32(4_000))
    mid = convert.aria_state_from_numpy(jax.tree.map(np.asarray, mid_r),
                                        "cpu")
    want = ref_aria._run_seg_dyn(stat_r, jax.tree.map(lambda x: x[1], dps_r),
                                 mid_r, jnp.int32(11_000))
    _assert_equal(jax.tree.map(np.asarray, want),
                  aria._run_seg_dyn(stat, dp, mid, 11_000))


def test_batch_ticks_is_the_advance_per_iteration():
    _, cfg = _cfgs(T=8, L=3, sync_lat=123, horizon=10_000)
    stat, dp = aria.split_aria(cfg, device="cpu")
    s = aria.init_aria_state(stat, "cpu")
    s1 = aria._run_seg_dyn(stat, dp, s, 1)
    assert int(s1.now) == aria.batch_ticks(cfg.workload, cfg.costs)


class TestAriaOrderings:
    """``tests/test_lock_engine.py::TestAria`` at a reduced size
    (horizon 25,000 instead of 400,000; T and R cut)."""
    HOT = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=R)

    def test_flat_scaling(self):
        r16 = extract_aria(16, simulate_aria(self.HOT, 16, horizon=25_000,
                                             device="cpu"))
        r64 = extract_aria(64, simulate_aria(self.HOT, 64, horizon=25_000,
                                             device="cpu"))
        assert r16.tps == pytest.approx(r64.tps, rel=0.05)

    def test_single_winner_per_batch(self):
        r = extract_aria(64, simulate_aria(self.HOT, 64, horizon=25_000,
                                           device="cpu"))
        assert r.abort_rate > 0.9     # one hotspot -> one winner

    def test_skew_rollbacks(self):
        w = WorkloadSpec(kind="zipf", zipf_s=0.99, txn_len=4, n_rows=4096)
        r = extract_aria(64, simulate_aria(w, 64, horizon=25_000,
                                           device="cpu"))
        assert r.abort_rate > 0.2
        ref = ref_aria.extract_aria(64, ref_aria.simulate_aria(
            RefWorkloadSpec(**dataclasses.asdict(w)), 64, horizon=25_000))
        assert r.__dict__ == ref.__dict__


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hot = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=R)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_aria(hot, 8, horizon=1_000)
