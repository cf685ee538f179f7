"""The certifier CLI's matrix run through both packages (shared by
tests/test_torch_trace.py and tests/test_torch_analysis.py, which split it
by workload kind so that ``--dist loadfile`` spreads it).

One case is a protocol and a kind at seed 1, ``p_abort`` 0.05, the CLI's
16 threads, 40,000 ticks and timeouts: the reference's traced run and the
port's traced run on the CPU, from the same numpy inputs (the same
``WorkloadSpec`` fields), held to each other event for event, leaf for
leaf and certificate for certificate.
"""
import dataclasses

import jax
import numpy as np

from repro.analysis import cli as ref_cli
from repro.analysis import isolation as ref_iso
from repro.core.lock import engine as ref_engine
from repro.obs import trace as ref_trace
from repro_torch.analysis import cli, isolation
from repro_torch.core.lock import convert, engine
from repro_torch.obs import trace

PROTOS = ["mysql", "o1", "o2", "group", "bamboo", "brook2pl"]
SEED, P_ABORT, CAP = 1, 0.05, 65_536


def _over(proto: str) -> dict:
    # brook2pl's timeout=0 IS the protocol; the others get the CLI's short
    # timeouts so detection-free deadlocks resolve inside the horizon
    return {} if proto == "brook2pl" else dict(cli.TIMEOUT_OVER)


def _rank(mod, proto: str, wl, **kw):
    """The chop acquisition ranks from ``mod``'s (either engine's)
    ``split_config``, for an ordered-acquire protocol."""
    pp = mod.protocol_params(proto)
    if not pp.ordered_acquire:
        return None
    cfg = mod.EngineConfig(protocol=pp, costs=mod.CostModel(), workload=wl,
                           n_threads=cli.THREADS, horizon=cli.HORIZON,
                           p_abort=P_ABORT, seed=SEED)
    return [int(r) for r in np.asarray(mod.split_config(cfg, **kw)[1]
                                       .wl.acq_rank)]


def check_case(proto: str, kind: str) -> None:
    """Run one case through both packages and hold the port to the
    reference: events, state, certificate, and the trace's wait bound."""
    assert cli.TIMEOUT_OVER == ref_cli.TIMEOUT_OVER
    assert (cli.THREADS, cli.HORIZON) == (ref_cli.THREADS, ref_cli.HORIZON)
    rw, pw = ref_cli._workload(kind, SEED), cli._workload(kind, SEED)
    assert dataclasses.asdict(rw) == dataclasses.asdict(pw)
    run = dict(horizon=cli.HORIZON, p_abort=P_ABORT, seed=SEED, cap=CAP,
               **_over(proto))
    rs, rtb = ref_trace.simulate_traced(proto, rw, cli.THREADS, **run)
    ps, ptb = trace.simulate_traced(proto, pw, cli.THREADS, device="cpu",
                                    **run)
    want, got = ref_trace.events_host(rtb), trace.events_host(ptb)

    # events, event for event, and the counters
    assert got["dropped"] == 0
    for k in ("n", "dropped", "cap"):
        assert got[k] == want[k], k
    for k in ("ts", "tid", "row", "ev"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.all(np.diff(got["ts"]) >= 0)        # time-ordered

    # the traced run's state, leaf for leaf
    a, b = jax.tree.map(np.asarray, rs), convert.state_to_numpy(ps)
    for part in ("th", "rows", "g"):
        for f, x, y in zip(getattr(a, part)._fields, getattr(a, part),
                           getattr(b, part)):
            np.testing.assert_array_equal(y, x, err_msg=f"{part}.{f}")
    g = b.g
    assert int((got["ev"] == trace.EV_COMMIT).sum()) == int(g.commits)
    assert int((got["ev"] == trace.EV_ABORT).sum()) == \
        int(g.user_aborts) + int(g.forced_aborts)

    # the certificate, field for field (brook2pl's ranks from each
    # package's split_config)
    rank_r = _rank(ref_engine, proto, rw)
    rank_p = _rank(engine, proto, pw, device="cpu")
    assert rank_p == rank_r
    c_ref = ref_iso.certify(want, ref_engine.protocol_params(
        proto, **_over(proto)), acq_rank=rank_r)
    c_port = isolation.certify(ptb, engine.protocol_params(
        proto, **_over(proto)), acq_rank=rank_p)
    assert dataclasses.asdict(c_port) == dataclasses.asdict(c_ref)
    assert c_port.ok, c_port.text()

    # resolved wait spans never exceed the lock-wait bin
    wait = isolation.total_trace_wait_ticks(ptb)
    assert wait == ref_iso.total_trace_wait_ticks(want)
    assert wait <= int(g.tb[:, engine.TB_LOCKWAIT].astype(np.int64).sum())

