"""Certifier report runner: ``python -m repro_torch.analysis.cli``.

    python -m repro_torch.analysis.cli [--quick] [--selftest] [--device cuda]

Runs the serializability certifier over a protocol x seed x workload matrix
of traced engine runs on ``--device`` (default: the CUDA card), prints a
report, and exits non-zero on any finding. ``--selftest`` also proves the
certifier can fail: a synthetically cyclic trace and a corrupted one must
be REJECTED. The reference's CLI also runs its jaxpr trace-leak linter;
the port captures no graphs, so there is nothing to lint.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core.lock.costs import PROTOCOLS
from ..core.lock.workload import WorkloadSpec
from ..obs.trace import EV_COMMIT, EV_GRANT
from . import isolation

# certifier matrix defaults; timeouts shortened so the detection-free
# protocols resolve deadlocks inside the short horizon (brook2pl keeps
# its protocol-defining timeout=0)
KINDS = ("zipf", "tpcc", "hotspot_update")
SEEDS = (1, 2, 3)
HORIZON = 40_000
THREADS = 16
TIMEOUT_OVER = dict(wait_timeout=8_000, commit_wait_timeout=8_000)


def _workload(kind: str, seed: int) -> WorkloadSpec:
    if kind == "tpcc":
        return WorkloadSpec(kind="tpcc", n_rows=256, txn_len=4,
                            n_warehouses=4, seed=seed)
    if kind == "hotspot_update":
        return WorkloadSpec(kind="hotspot_update", n_rows=256, txn_len=4,
                            n_hot=4, seed=seed)
    return WorkloadSpec(kind="zipf", n_rows=256, txn_len=4, zipf_s=1.1,
                        seed=seed)


def run_certify_matrix(kinds=KINDS, seeds=SEEDS, p_abort: float = 0.05,
                       verbose: bool = True, device=None) -> list:
    certs = []
    for proto in PROTOCOLS:
        over = {} if proto == "brook2pl" else dict(TIMEOUT_OVER)
        for kind in kinds:
            for seed in seeds:
                c = isolation.certify_run(
                    proto, _workload(kind, seed), THREADS,
                    horizon=HORIZON, p_abort=p_abort, seed=seed,
                    device=device, **over)
                certs.append((kind, seed, c))
                if verbose:
                    ok = "ok  " if c.ok else "FAIL"
                    print(f"{ok} {proto:<9} {kind:<15} seed={seed} "
                          f"committed={c.n_committed} "
                          f"aborted={c.n_aborted} edges={c.n_edges}")
                    if not c.ok:
                        print(c.text())
    return certs


# ---------------------------------------------------------------------------
# selftest fixtures: traces the certifier must reject
# ---------------------------------------------------------------------------

def cyclic_events() -> dict:
    """Two committed attempts acquiring rows 1 and 2 in opposite orders:
    ww edges A->B (row 1) and B->A (row 2) — a conflict cycle no 2PL
    schedule can produce."""
    ev = [(0, 0, 1, EV_GRANT), (0, 1, 2, EV_GRANT),
          (5, 1, 1, EV_GRANT), (5, 0, 2, EV_GRANT),
          (9, 0, -1, EV_COMMIT), (9, 1, -1, EV_COMMIT)]
    return {"ts": np.array([e[0] for e in ev]),
            "tid": np.array([e[1] for e in ev]),
            "row": np.array([e[2] for e in ev]),
            "ev": np.array([e[3] for e in ev]),
            "n": len(ev), "dropped": 0, "cap": len(ev)}


def corrupted_events() -> dict:
    """Time-travelling buffer (ts not monotone) with a rogue event id."""
    ev = cyclic_events()
    ev["ts"] = np.array([0, 5, 3, 5, 9, 9])     # 5 -> 3 travels back
    ev["ev"] = ev["ev"].copy()
    ev["ev"][4] = 99                            # outside EVENTS
    return ev


def run_selftest(verbose: bool = True) -> list:
    fails = []
    cyc = isolation.certify(cyclic_events(), "mysql")
    if cyc.serializable or cyc.ok:
        fails.append("selftest: cyclic trace was certified serializable")
    bad = isolation.certify(corrupted_events(), "mysql")
    if bad.ok or not any("input-invalid" in v for v in bad.violations):
        fails.append("selftest: corrupted trace was not rejected")
    if verbose:
        print(f"selftest: cyclic trace "
              f"{'rejected' if not cyc.serializable else 'MISSED'}; "
              f"corrupted trace {'rejected' if not bad.ok else 'MISSED'}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true",
                    help="also run the must-fail negative controls")
    ap.add_argument("--quick", action="store_true",
                    help="1 seed / 2 kinds certifier matrix")
    ap.add_argument("--device", default="cuda",
                    help="device of the traced runs (default: cuda)")
    args = ap.parse_args(argv)
    failures = 0

    t0 = time.time()
    kinds = KINDS[:2] if args.quick else KINDS
    seeds = SEEDS[:1] if args.quick else SEEDS
    certs = run_certify_matrix(kinds=kinds, seeds=seeds, device=args.device)
    bad = [c for _k, _s, c in certs if not c.ok]
    print(f"# certify: {len(certs) - len(bad)}/{len(certs)} runs "
          f"certified, wall: {time.time() - t0:.1f}s")
    failures += len(bad)

    if args.selftest:
        st = run_selftest()
        for s in st:
            print(s)
        failures += len(st)

    print("analysis: " + ("PASS" if failures == 0 else
                          f"FAIL ({failures} failure(s))"))
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
