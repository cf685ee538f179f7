"""Port parity of the event tracer (``repro_torch.obs.trace``) against
``repro.obs.trace`` on the CPU.

- trace-off parity per protocol: ``trace_on=False`` equals the untraced
  engine leaf for leaf with an empty buffer, and ``trace_on=True`` leaves
  the state unchanged (tests/test_obs.py::TestTraceOffParity at 16 threads
  and 8,000 ticks, cut from 24 and 60,000 for the file's time);
- ``events_host`` equal to the reference's event for event, with the
  state, the certificate and the wait bound, on the certifier CLI's matrix
  at seed 1 with ``p_abort`` 0.05 for the zipf and hotspot_update kinds
  (tpcc is in tests/test_torch_analysis.py);
- overflow drops keep the prefix and count the rest;
- a reference ``TraceBuf`` and state taken at a segment boundary resume in
  the port (``convert.trace_from_numpy``) and end equal to the reference's
  single-shot traced run, events included.

tests/test_obs.py's TestCompileKey (one executable per capacity and
switch) has no counterpart: eager torch compiles nothing.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.lock import engine as ref_engine
from repro.core.lock import WorkloadSpec as RefWorkloadSpec
from repro.obs import trace as ref_trace
from repro_torch.core.lock import WorkloadSpec, convert, engine, simulate
from repro_torch.obs import trace
from repro_torch.obs.trace import (EV_COMMIT, events_host, make_trace,
                                   simulate_traced)
from torch_trace_matrix import PROTOS, check_case

ZIPF = dict(kind="zipf", txn_len=4, n_rows=512, zipf_s=0.9)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_equal(a, b):
    a, b = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for part in ("th", "rows", "g"):
        for f, x, y in zip(getattr(a, part)._fields, getattr(a, part),
                           getattr(b, part)):
            np.testing.assert_array_equal(x, y, err_msg=f"{part}.{f}")


@pytest.mark.parametrize("proto", PROTOS)
def test_trace_off_and_on_leave_the_run_unchanged(proto):
    wl = WorkloadSpec(**ZIPF)
    run = dict(n_threads=16, horizon=8_000, device="cpu")
    s_ref = simulate(proto, wl, **run)
    s_off, tb = simulate_traced(proto, wl, trace_on=False, **run)
    _leaves_equal(s_off, s_ref)
    assert int(tb.n) == 0 and int(tb.dropped) == 0
    assert bool((tb.ts == -1).all())
    s_on, tb_on = simulate_traced(proto, wl, **run)
    _leaves_equal(s_on, s_ref)
    assert int(tb_on.n) > 0


@pytest.mark.parametrize("kind", ["zipf", "hotspot_update"])
@pytest.mark.parametrize("proto", PROTOS)
def test_events_equal_the_reference_on_the_cli_matrix(proto, kind):
    check_case(proto, kind)


def test_overflow_drops_keep_the_prefix():
    wl = WorkloadSpec(**ZIPF)
    run = dict(n_threads=16, horizon=8_000, device="cpu", alloc=4096)
    _, big = simulate_traced("mysql", wl, cap=4096, **run)
    _, small = simulate_traced("mysql", wl, cap=64, **run)
    ev_b, ev_s = events_host(big), events_host(small)
    assert ev_b["dropped"] == 0 and ev_b["n"] > 64
    assert ev_s["n"] == 64 and ev_s["cap"] == 64
    assert ev_s["dropped"] == ev_b["n"] - 64
    for col in ("ts", "tid", "row", "ev"):
        np.testing.assert_array_equal(ev_s[col], ev_b[col][:64])
    # the reference drops the same events
    _, ref_small = ref_trace.simulate_traced(
        "mysql", RefWorkloadSpec(**ZIPF), 16, horizon=8_000, cap=64,
        alloc=4096)
    assert ref_trace.events_host(ref_small)["dropped"] == ev_s["dropped"]


def test_record_appends_in_block_order_and_drops_at_cap():
    """One synthetic iteration: start-of-interval blocks first, threads
    ascending, the sink slot taking what does not fit."""
    T = 3
    z = torch.zeros((1, T), dtype=torch.bool)
    rows = torch.tensor([[5, 6, 7]], dtype=torch.int32)
    se = engine.StepEvents(
        t_pre=torch.tensor([10], dtype=torch.int32),
        t_post=torch.tensor([12], dtype=torch.int32),
        row_cur=rows, row_begin=rows + 10,
        grant=torch.tensor([[True, False, True]]), group_join=z,
        timeout=torch.tensor([[False, True, False]]), victim=z,
        release=z, commit=torch.tensor([[False, False, True]]),
        wait_enter=torch.tensor([[True, False, False]]), abort=z)
    rec = trace._Recorder(make_trace(cap=4, alloc=6, device="cpu"), T)
    rec(se)
    tb = rec.buf()
    ev = events_host(tb)
    assert (ev["n"], ev["dropped"], ev["cap"]) == (4, 1, 4)
    assert ev["ev"].tolist() == [trace.EV_TIMEOUT, trace.EV_GRANT,
                                 trace.EV_GRANT, EV_COMMIT]
    assert ev["tid"].tolist() == [1, 0, 2, 2]
    assert ev["row"].tolist() == [6, 5, 7, -1]
    assert ev["ts"].tolist() == [10, 10, 10, 12]
    # slots past cap stay untouched; one more slot is the sink
    assert tb.ts[4:6].tolist() == [-1, -1] and tb.ts.shape == (7,)


@pytest.mark.parametrize("proto,kind", [("mysql", "zipf"),
                                        ("brook2pl", "tpcc")])
def test_reference_trace_resumes_in_the_port(proto, kind):
    over = {} if proto == "brook2pl" else dict(wait_timeout=8_000,
                                               commit_wait_timeout=8_000)
    wl = RefWorkloadSpec(kind=kind, n_rows=256, txn_len=4, zipf_s=1.1,
                         n_warehouses=4, seed=1)
    cfg = ref_engine.EngineConfig(
        protocol=ref_engine.protocol_params(proto, **over),
        costs=ref_engine.CostModel(), workload=wl, n_threads=16,
        horizon=12_000, p_abort=0.05, seed=1, attrib=True)
    stat, dp = ref_engine.split_config(cfg)
    s0 = ref_engine.init_state_dyn(stat, dp)
    s_whole, tb_whole, _ = ref_trace.run_traced(stat, dp, s0,
                                                ref_trace.make_trace(8192))
    s_mid, tb_mid, _ = ref_trace.run_traced(stat, dp, s0,
                                            ref_trace.make_trace(8192),
                                            until=5_000)
    host = lambda x: jax.tree.map(np.asarray, x)     # noqa: E731
    s, tb, _ = trace.run_traced(
        engine.StaticShape(*stat),
        convert.params_from_numpy(host(dp), device="cpu"),
        convert.state_from_numpy(host(s_mid), device="cpu"),
        convert.trace_from_numpy(host(tb_mid), device="cpu"))
    want = host(s_whole)
    got = convert.state_to_numpy(s)
    for part in ("th", "rows", "g"):
        for f, x, y in zip(getattr(want, part)._fields, getattr(want, part),
                           getattr(got, part)):
            np.testing.assert_array_equal(y, x, err_msg=f"{part}.{f}")
    # the whole buffer, in the reference's layout, sink dropped
    tn, tw = convert.trace_to_numpy(tb), host(tb_whole)
    assert 0 < int(tn.n) and int(tb_mid.n) < int(tn.n)
    for f in tw._fields:
        x, y = np.asarray(getattr(tw, f)), getattr(tn, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)
