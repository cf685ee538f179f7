"""Port parity: the PyTorch lock engine equals ``engine._run_dyn`` of the JAX
reference in every ``SimState`` leaf, bit for bit (int, bool and f32)."""
import numpy as np
import jax
import pytest
import torch

from repro.core.lock import engine as ref_engine
from repro.core.lock import (CostModel as RefCostModel,
                             WorkloadSpec as RefWorkloadSpec)
from repro_torch.core.lock import (EngineConfig, WorkloadSpec, CostModel,
                                   protocol_params, run_sim)
from repro_torch.core.lock import engine, convert

PROTOS = ["mysql", "o1", "o2", "group", "bamboo", "brook2pl"]
KINDS = ["hotspot_update", "zipf", "tpcc"]


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


def _assert_accounting(s, T):
    g = convert.state_to_numpy(s).g
    # tick conservation (i32, exact mod 2**32) and the ca/lock_wait identity
    assert int(g.tb.astype(np.int64).sum()) % 2**32 == \
        (T * int(g.now)) % 2**32
    assert int(g.ca[engine.CA_WAIT].astype(np.int64).sum()) == \
        int(g.tb[:, engine.TB_LOCKWAIT].astype(np.int64).sum())


@pytest.mark.parametrize("p_abort", [0.0, 0.05])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("proto", PROTOS)
def test_simulate_bit_equal(proto, kind, p_abort):
    ref_cfg, cfg = _configs(proto, kind, p_abort=p_abort)
    want = _ref_run(ref_cfg)
    got = run_sim(cfg, device="cpu")
    _assert_states_equal(want, got)
    _assert_accounting(got, cfg.n_threads)
    assert int(got.g.commits) > 0


def test_step_events_exported_as_the_reference():
    """``StepEvents`` is public in ``repro_torch.core.lock`` as in the
    reference's package, with the reference's fields; every name the
    reference's package exports, the port's does too."""
    import repro.core.lock as ref_lock
    import repro_torch.core.lock as lock
    assert lock.StepEvents is engine.StepEvents
    assert "StepEvents" in lock.__all__
    assert lock.StepEvents._fields == ref_lock.StepEvents._fields
    assert set(ref_lock.__all__) <= set(lock.__all__), \
        set(ref_lock.__all__) - set(lock.__all__)
