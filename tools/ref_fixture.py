#!/usr/bin/env python3
"""Write the reference fixture that ``chip_smoke.py`` holds the card to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_fixture.py [--check]
        [--workers N] [--out PATH]

The card host has no JAX, so the JAX package's answers travel to it in a
committed file, ``tests/ref/engine_ref.json``. This script runs the JAX
package (``src/repro``) on the CPU over the configurations that
``chip_smoke.py``'s configuration functions make, given the reference's
packages instead of the port's, and writes for each entry its full
configuration (``convert.config_doc``) and the reference's answer:

* ``engine_full``: the engine phase's seven full-width runs (T=1024,
  R=1,000,000, 20,000 ticks): ``iters``, ``commits``, ``now`` and every
  ``SimState`` leaf's digest (``convert.state_digests``);
* ``engine_mid``: the six mid-size runs (T=64, R=4,096, 10,000 ticks),
  every leaf's digest;
* ``fig8``: Figure 8's 24 points at 120,000 ticks on R=1,000,000, one
  record each from a per-config run (``simulate`` + ``extract``, as
  ``tests/test_sweep.py::reference``);
* ``uncut``: the points of ``tests/test_sweep.py``'s parity and
  compaction grids at their own horizons, and ``TestAria``'s runs at
  400,000 ticks, records as above;
* ``governed_served``: the governed and open-load serving packs, every
  cell's result and segment records.

It also records the format version (``chip_smoke.REF_FORMAT``), the JAX
version and the git blob ids of the reference's engine, sweep, governor
and serving sources. The jobs run in a pool of spawned processes; the
output is deterministic (8 CPU cores: about 10-20 minutes). ``--check``
recomputes every entry and compares it with the committed file, exiting 1
on any difference.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "ref" / "engine_ref.json"
# the sources whose behaviour the fixture records
REF_SOURCES = ("src/repro/core/lock", "src/repro/sweep", "src/repro/adaptive",
               "src/repro/serving")


def _setup() -> None:
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))


def smoke():
    """``chip_smoke.py`` as a module (no card needed to build configs)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke"] = mod
    return sys.modules["chip_smoke"]


def ref_api() -> SimpleNamespace:
    """The reference's packages, as the configuration functions take them."""
    _setup()
    import repro.adaptive
    import repro.core.lock
    import repro.serving
    import repro.sweep
    return SimpleNamespace(lock=repro.core.lock, sweep=repro.sweep,
                           adaptive=repro.adaptive, serving=repro.serving)


def blob_id(path: Path) -> str:
    """git's blob id of a file (``git hash-object``)."""
    data = path.read_bytes()
    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def reference_record(p) -> dict:
    """One sweep point's record from the reference's per-config run."""
    from repro.core.lock import (extract, extract_aria, simulate,
                                 simulate_aria)
    from repro_torch.core.lock.convert import sim_record
    if p.protocol == "aria":
        s = simulate_aria(p.workload, p.n_threads, costs=p.costs,
                          horizon=p.horizon)
        return sim_record(extract_aria(p.n_threads, s))
    s = simulate(p.protocol, p.workload, p.n_threads, costs=p.costs,
                 horizon=p.horizon, p_abort=p.p_abort, drain=p.drain,
                 **p.over())
    return sim_record(extract(p.protocol, p.n_threads, s))


def _json(x):
    """``x`` as the plain JSON tree the fixture stores."""
    from repro_torch.core.lock.convert import canonical
    return json.loads(canonical(x))


def configs() -> dict:
    """Every entry's configurations, by entry and name, in the reference's
    types."""
    cs, api = smoke(), ref_api()
    return {
        "engine_full": cs.engine_full_configs(cs.REF_ENGINE_HORIZON, api),
        "engine_mid": cs.engine_mid_configs(api),
        "fig8": {p.name: p for p in cs.fig8_points(cs.FIG8_HORIZON,
                                                   api=api)},
        "uncut": {p.name: p for p in cs.ref_full_points(api)},
        "governed_served": {"governed": cs.governed_spec(api),
                            "served": cs.served_spec(api)},
    }


def job(entry: str, name: str) -> tuple[str, str, dict, float]:
    """One fixture item, computed by the reference: (entry, name, item,
    seconds)."""
    import jax
    import numpy as np
    from repro.core.lock import engine as ref_engine
    from repro_torch.core.lock.convert import config_doc
    cs = smoke()
    cfg = configs()[entry][name]
    t0 = time.perf_counter()
    item = {"config": config_doc(cfg)}
    if entry in ("engine_full", "engine_mid"):
        s = jax.tree.map(np.asarray, ref_engine.run_sim(cfg))
        item.update(cs.engine_summary(s))
    elif entry in ("fig8", "uncut"):
        item["record"] = reference_record(cfg)
    elif name == "governed":
        from repro.adaptive import run_governed
        item["records"] = cs.governed_records(run_governed(**cfg))
    else:
        from repro.serving import serve
        item["records"] = cs.served_records(serve(**cfg))
    return entry, name, _json(item), time.perf_counter() - t0


def build(workers: int) -> dict:
    """The whole fixture document."""
    import jax
    cs = smoke()
    todo = [(e, n) for e, items in configs().items() for n in items]
    # the longest jobs first: full width, then Figure 8's wide points
    order = {"engine_full": 0, "fig8": 1, "governed_served": 2,
             "engine_mid": 3, "uncut": 4}
    todo.sort(key=lambda en: order[en[0]])
    items = {e: {} for e in order}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, ctx, initializer=_setup) as pool:
        for entry, name, item, sec in pool.map(job, *zip(*todo)):
            items[entry][name] = item
            print(f"{entry}/{name}: {sec:.1f} s", file=sys.stderr,
                  flush=True)
    files = sorted(f for d in REF_SOURCES for f in (ROOT / d).glob("*.py"))
    return {
        "format": cs.REF_FORMAT,
        "jax": jax.__version__,
        "reference_blobs": {str(f.relative_to(ROOT)): blob_id(f)
                            for f in files},
        "engine_full": {"horizon": cs.REF_ENGINE_HORIZON,
                        "runs": items["engine_full"]},
        "engine_mid": {"runs": items["engine_mid"]},
        "fig8": {"horizon": cs.FIG8_HORIZON, "points": items["fig8"]},
        "uncut": {"points": items["uncut"]},
        "governed_served": items["governed_served"],
    }


def differences(old, new, path="", depth=3) -> list[str]:
    """Where two fixture documents differ: "entry part name" paths."""
    if depth and isinstance(old, dict) and isinstance(new, dict):
        return [d for k in sorted(old.keys() | new.keys())
                for d in differences(old.get(k), new.get(k),
                                     f"{path}{k} ", depth - 1)]
    return [] if old == new else [path.strip()]


def dumps(doc: dict) -> str:
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="recompute and compare with the committed file")
    ap.add_argument("--workers", type=int,
                    default=max(1, min(6, (os.cpu_count() or 2) - 1)))
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    # the reference on the CPU, in this process and the spawned workers
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    t0 = time.perf_counter()
    text = dumps(build(args.workers))
    print(f"built in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if not args.check:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
        print(f"wrote {args.out} ({len(text)} bytes)")
        return 0
    if text != args.out.read_text():
        print("differs from the committed fixture:",
              differences(json.loads(args.out.read_text()),
                          json.loads(text)) or "(formatting)")
        return 1
    print(f"{args.out} reproduced bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
