"""Port parity of the serializability certifier
(``repro_torch.analysis``) against ``repro.analysis`` on the CPU.

- the certifier CLI's matrix for the tpcc kind (seed 1, ``p_abort`` 0.05;
  zipf and hotspot_update are in tests/test_torch_trace.py): events, state
  and ``Certificate`` fields equal to the reference's, every run certified,
  the trace's resolved waits within the lock-wait bin;
- ``certify_run``'s brook2pl chop mode and its ``Certificate`` against the
  reference's (10,000 ticks, cut from tests/test_analysis.py's 40,000 for
  the file's time);
- the negative controls: the selftest's cyclic and corrupted traces, a
  descending brook rank, a capacity-truncated trace as a lower bound;
- the CLI: its matrix equal to the reference CLI's (``--quick`` at 2,000
  ticks), its selftest, and its default device, the card.

tests/test_analysis.py's TestLint has no counterpart: the port captures no
graphs, so there is nothing for a jaxpr trace-leak linter to check.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import cli as ref_cli
from repro.analysis import isolation as ref_iso
from repro.core.lock import WorkloadSpec as RefWorkloadSpec
from repro_torch.analysis import cli, isolation
from repro_torch.core.lock import WorkloadSpec, protocol_params
from repro_torch.obs.trace import (EV_COMMIT, EV_GRANT, EV_WAIT_ENTER,
                                   simulate_traced)
from torch_trace_matrix import PROTOS, check_case

W_ZIPF = dict(kind="zipf", n_rows=256, txn_len=4, zipf_s=1.1)
TIMEOUTS = dict(wait_timeout=8_000, commit_wait_timeout=8_000)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("proto", PROTOS)
def test_tpcc_matrix_certifies_as_the_reference(proto):
    check_case(proto, "tpcc")


@pytest.mark.parametrize("proto,over", [("brook2pl", {}),
                                        ("mysql", TIMEOUTS)])
def test_certify_run_modes_equal_the_reference(proto, over):
    """brook2pl certifies in chop-piece mode with txn-level ww cycles (the
    chopping signature) and strict mysql in txn-ww mode without them,
    each certificate field for field the reference's."""
    run = dict(horizon=10_000, p_abort=0.05, seed=1, **over)
    c = isolation.certify_run(proto, WorkloadSpec(**W_ZIPF), 16,
                              device="cpu", **run)
    want = ref_iso.certify_run(proto, RefWorkloadSpec(**W_ZIPF), 16, **run)
    assert dataclasses.asdict(c) == dataclasses.asdict(want)
    assert c.ok, c.text()
    if proto == "brook2pl":
        assert c.mode == "chop-piece" and c.chop_ww_cycles
    else:
        assert c.mode == "txn-ww" and not c.chop_ww_cycles


def _events(rows):
    return {"ts": np.array([e[0] for e in rows]),
            "tid": np.array([e[1] for e in rows]),
            "row": np.array([e[2] for e in rows]),
            "ev": np.array([e[3] for e in rows]),
            "n": len(rows), "dropped": 0, "cap": len(rows)}


def test_brook_rank_check_rejects_descending():
    events = _events([(0, 0, 5, EV_WAIT_ENTER), (1, 0, 5, EV_GRANT),
                      (2, 0, 2, EV_WAIT_ENTER), (3, 0, 2, EV_GRANT),
                      (9, 0, -1, EV_COMMIT)])
    c = isolation.certify(events, protocol_params("brook2pl"),
                          acq_rank=list(range(8)))
    assert any("brook-rank" in v for v in c.violations), c.text()


def test_selftest_traces_are_rejected():
    for name in ("cyclic_events", "corrupted_events"):
        ev, ref_ev = getattr(cli, name)(), getattr(ref_cli, name)()
        for k in ("ts", "tid", "row", "ev"):
            np.testing.assert_array_equal(ev[k], ref_ev[k])
    cyc = isolation.certify(cli.cyclic_events(), "mysql")
    assert not cyc.serializable and cyc.cycle is not None and not cyc.ok
    bad = isolation.certify(cli.corrupted_events(), "mysql")
    assert not bad.ok
    assert any("input-invalid" in v for v in bad.violations)
    for c, ref_c in [(cyc, ref_iso.certify(ref_cli.cyclic_events(),
                                           "mysql")),
                     (bad, ref_iso.certify(ref_cli.corrupted_events(),
                                           "mysql"))]:
        assert dataclasses.asdict(c) == dataclasses.asdict(ref_c)
    assert cli.run_selftest(verbose=False) == []


def test_dropped_trace_is_a_lower_bound():
    _s, tb = simulate_traced("mysql", WorkloadSpec(**W_ZIPF), 16,
                             horizon=5_000, seed=1, cap=64, device="cpu",
                             **TIMEOUTS)
    assert int(tb.dropped) > 0
    c = isolation.certify(tb, "mysql")
    assert c.lower_bound


def test_cli_matrix_equals_the_reference_cli(monkeypatch, capsys):
    monkeypatch.setattr(cli, "HORIZON", 2_000)
    monkeypatch.setattr(ref_cli, "HORIZON", 2_000)
    kinds, seeds = cli.KINDS[:2], cli.SEEDS[:1]
    got = cli.run_certify_matrix(kinds=kinds, seeds=seeds, verbose=False,
                                 device="cpu")
    want = ref_cli.run_certify_matrix(kinds=kinds, seeds=seeds,
                                      verbose=False)
    assert len(got) == len(want) == len(PROTOS) * 2
    for (k, s, c), (rk, rs, rc) in zip(got, want):
        assert (k, s) == (rk, rs)
        assert dataclasses.asdict(c) == dataclasses.asdict(rc)
    assert cli.main(["--quick", "--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "analysis: PASS" in out and "certify: 12/12" in out


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--quick"])
