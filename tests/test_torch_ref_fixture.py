"""The reference fixture (``tests/ref/engine_ref.json``) that
``chip_smoke.py`` holds the card to, since the card host has no JAX.

``tools/ref_fixture.py`` writes it from the JAX package's own runs. Here:

* a few of its entries, recomputed with the JAX package, equal the file
  (a stale fixture fails), and the port on the CPU equals them too;
* ``convert.state_digests`` gives equal digests for a reference state and
  its port, and a change to one element of a leaf changes that leaf's
  digest and no other;
* the configurations ``chip_smoke.py`` builds for each entry equal the
  fixture's, field for field, as do the reference's sources' blob ids.
"""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.lock import aria as ref_aria
from repro.core.lock import engine as ref_engine
from repro.core.lock import CostModel as RefCostModel
from repro.core.lock import WorkloadSpec as RefWorkloadSpec
from repro_torch.core.lock import (CostModel, WorkloadSpec, engine,
                                   extract, extract_aria, run_sim, simulate,
                                   simulate_aria, stack_lanes)
from repro_torch.core.lock.convert import (FLOAT_FIELDS, INT_FIELDS,
                                           canonical, config_doc,
                                           sim_record, state_digests,
                                           state_to_numpy)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "ref" / "engine_ref.json"
# the cheapest uncut points: two engine lanes of the fewest iterations (a
# padded o2 lane that stalls, group at 60,000 ticks) and an Aria lane with
# a long batch time
CHEAP_UNCUT = ("padded/oz4", "mixed_density/group_T64",
               "aria_staggered/aria_T16_s9000")
MID_PROTOCOLS = ("group", "bamboo")


def _load(name: str, path: Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def tool():
    return _load("ref_fixture", ROOT / "tools" / "ref_fixture.py")


@pytest.fixture(scope="module")
def fixture():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- (a), (b)

@pytest.mark.parametrize("proto", MID_PROTOCOLS)
def test_engine_mid_recomputed_by_the_reference(tool, fixture, proto):
    """The reference's run of an ``engine_mid`` config, recomputed now,
    equals the fixture's item (config, iters, commits, now, digests)."""
    _, _, item, _ = tool.job("engine_mid", proto)
    assert item == fixture["engine_mid"]["runs"][proto]


@pytest.mark.parametrize("proto", MID_PROTOCOLS)
def test_engine_mid_port_on_cpu(smoke, fixture, proto):
    """The port's run of the same config on the CPU: every leaf's digest
    equal."""
    cfg = smoke.engine_mid_configs()[proto]
    got = smoke.engine_summary(run_sim(cfg, device="cpu"))
    want = fixture["engine_mid"]["runs"][proto]
    assert smoke.differing_leaves(got["digests"], want["digests"]) == []
    assert {k: got[k] for k in ("iters", "commits", "now")} == \
        {k: want[k] for k in ("iters", "commits", "now")}


@pytest.mark.parametrize("name", CHEAP_UNCUT)
def test_uncut_recomputed_by_the_reference(tool, fixture, name):
    _, _, item, _ = tool.job("uncut", name)
    assert item == fixture["uncut"]["points"][name]


@pytest.mark.parametrize("name", CHEAP_UNCUT)
def test_uncut_port_on_cpu(smoke, fixture, name):
    """The port's per-config run of the point (``simulate`` + ``extract``,
    as tests/test_sweep.py's ``reference``): the record equal."""
    p = {p.name: p for p in smoke.ref_full_points()}[name]
    if p.protocol == "aria":
        r = extract_aria(p.n_threads, simulate_aria(
            p.workload, p.n_threads, costs=p.costs, horizon=p.horizon,
            device="cpu"))
    else:
        r = extract(p.protocol, p.n_threads, simulate(
            p.protocol, p.workload, p.n_threads, costs=p.costs,
            horizon=p.horizon, p_abort=p.p_abort, drain=p.drain,
            device="cpu", **p.over()))
    assert canonical(sim_record(r)) == canonical(
        fixture["uncut"]["points"][name]["record"])


@pytest.mark.parametrize("kind", ["governed", "served"])
def test_packs_recomputed_by_the_reference(tool, fixture, kind):
    """The reference's governed and served packs, recomputed now: every
    cell's records equal the fixture's."""
    _, _, item, _ = tool.job("governed_served", kind)
    assert item == fixture["governed_served"][kind]


@pytest.mark.parametrize("kind", ["governed", "served"])
def test_packs_port_on_cpu(smoke, fixture, kind):
    """The port's packs on the CPU at the reference tests' horizons (30,000
    and 20,000 ticks): every cell's whole-run metrics, segment and boundary
    records and serving result equal the fixture's."""
    from repro_torch.adaptive import run_governed
    from repro_torch.serving import serve
    if kind == "governed":
        got = smoke.governed_records(run_governed(**smoke.governed_spec(),
                                                  device="cpu"))
    else:
        got = smoke.served_records(serve(**smoke.served_spec(),
                                         device="cpu"))
    want = fixture["governed_served"][kind]["records"]
    assert sorted(got) == sorted(want)
    assert [f"{n}:{part}" for n in got for part in got[n]
            if canonical(got[n][part]) != canonical(want[n][part])] == []


# --------------------------------------------------------------- (c)

def _tiny_states():
    """A tiny engine run and a tiny Aria run in both packages, as numpy."""
    wl = dict(kind="zipf", n_rows=32, txn_len=3, zipf_s=0.9, seed=2)
    run = dict(n_threads=8, horizon=600, p_abort=0.1, attrib=True)
    ref_cfg = ref_engine.EngineConfig(
        protocol=ref_engine.protocol_params("bamboo"),
        costs=RefCostModel(), workload=RefWorkloadSpec(**wl), **run)
    cfg = engine.EngineConfig(protocol=engine.protocol_params("bamboo"),
                              costs=CostModel(), workload=WorkloadSpec(**wl),
                              **run)
    eng = (jax.tree.map(np.asarray, ref_engine.run_sim(ref_cfg)),
           state_to_numpy(run_sim(cfg, device="cpu")))
    ar = (jax.tree.map(np.asarray, ref_aria.simulate_aria(
              RefWorkloadSpec(**wl), 8, horizon=2_000)),
          state_to_numpy(simulate_aria(WorkloadSpec(**wl), 8,
                                       horizon=2_000, device="cpu")))
    return {"engine": eng, "aria": ar}


@pytest.fixture(scope="module")
def tiny():
    return _tiny_states()


@pytest.mark.parametrize("kind", ["engine", "aria"])
def test_digests_agree_across_packages(tiny, kind):
    ref, port = tiny[kind]
    a, b = state_digests(ref), state_digests(port)
    assert a == b
    if kind == "engine":
        assert {k.split(".")[0] for k in a} == {"th", "rows", "g"}
        assert len(a) == sum(len(getattr(port, p)._fields)
                             for p in ("th", "rows", "g"))
    else:
        assert sorted(a) == sorted(port._fields)


def _flip(x: np.ndarray) -> np.ndarray:
    """``x`` with one element changed (its last, or a 0-d value)."""
    y = np.array(x, copy=True)
    flat = y.reshape(-1)
    if y.dtype == np.bool_:
        flat[-1] = ~flat[-1]
    else:
        flat[-1] = flat[-1] + 1
    return y


def _leaves(state, prefix=""):
    for f, x in zip(state._fields, state):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            yield from _leaves(x, f"{prefix}{f}.")
        else:
            yield prefix + f, x


def _replace_leaf(state, path, value):
    head, _, rest = path.partition(".")
    if not rest:
        return state._replace(**{head: value})
    return state._replace(**{head: _replace_leaf(getattr(state, head), rest,
                                                 value)})


@pytest.mark.parametrize("kind", ["engine", "aria"])
def test_one_changed_element_changes_one_digest(tiny, kind):
    _, port = tiny[kind]
    base = state_digests(port)
    for path, x in _leaves(port):
        if np.asarray(x).size == 0:
            continue
        d = state_digests(_replace_leaf(port, path, _flip(np.asarray(x))))
        assert [k for k in base if base[k] != d[k]] == [path], path
    # a dtype change alone changes the digest too
    path, x = next(_leaves(port))
    d = state_digests(_replace_leaf(port, path, np.asarray(x, np.int64)))
    assert [k for k in base if base[k] != d[k]] == [path]


def test_pack_lane_digests_equal_the_single_run():
    """``state_digests(pack, lane=i)`` of a pack equals the digests of
    lane i's own state."""
    cfgs = [engine.EngineConfig(
        protocol=engine.protocol_params(p), costs=CostModel(),
        workload=WorkloadSpec(kind="hotspot_update", txn_len=2, n_rows=64),
        n_threads=8, horizon=400) for p in ("mysql", "group")]
    singles = [state_to_numpy(run_sim(c, device="cpu")) for c in cfgs]
    parts = [engine.split_config(c, device="cpu") for c in cfgs]
    stat = parts[0][0]
    pack = state_to_numpy(engine._run_batch(
        stat, stack_lanes([dp for _, dp in parts]),
        stack_lanes([engine.init_state_dyn(stat, dp) for _, dp in parts])))
    for i, s in enumerate(singles):
        assert state_digests(pack, lane=i) == state_digests(s)
    assert state_digests(pack, lane=0) != state_digests(pack, lane=1)


# --------------------------------------------------------------- (d)

def test_fixture_header(smoke, tool, fixture):
    """The format is the smoke's, and the reference's sources are the ones
    the fixture was computed from (a change there makes it stale)."""
    assert fixture["format"] == smoke.REF_FORMAT
    assert fixture["engine_full"]["horizon"] == smoke.REF_ENGINE_HORIZON
    assert fixture["fig8"]["horizon"] == smoke.FIG8_HORIZON
    files = sorted(f for d in tool.REF_SOURCES
                   for f in (ROOT / d).glob("*.py"))
    assert fixture["reference_blobs"] == {
        str(f.relative_to(ROOT)): tool.blob_id(f) for f in files}


def _built(smoke, api=None) -> dict:
    """Each entry's configurations as chip_smoke.py builds them."""
    return {
        "engine_full": smoke.engine_full_configs(smoke.REF_ENGINE_HORIZON,
                                                 api),
        "engine_mid": smoke.engine_mid_configs(api),
        "fig8": {p.name: p for p in smoke.fig8_points(smoke.FIG8_HORIZON,
                                                      api=api)},
        "uncut": {p.name: p for p in smoke.ref_full_points(api)},
    }


def _items(fixture, entry):
    e = fixture[entry]
    return e.get("runs", e.get("points"))


@pytest.mark.parametrize("entry", ["engine_full", "engine_mid", "fig8",
                                   "uncut"])
def test_smoke_configs_equal_the_fixtures(smoke, tool, fixture, entry):
    """chip_smoke.py's configuration functions, given the port's packages
    or the reference's, give the fixture's configurations name for name."""
    items = _items(fixture, entry)
    for api in (None, tool.ref_api()):
        built = _built(smoke, api)[entry]
        assert sorted(built) == sorted(items)
        for name, obj in built.items():
            assert canonical(config_doc(obj)) == canonical(
                items[name]["config"]), (entry, name)
    # the cheap items this file recomputes are in the fixture
    assert set(CHEAP_UNCUT) <= set(_items(fixture, "uncut"))


def test_smoke_packs_equal_the_fixtures(smoke, tool, fixture):
    """The governed and served packs' arguments (cells, horizons, chunk
    widths) as chip_smoke.py builds them."""
    entry = fixture["governed_served"]
    for api in (None, tool.ref_api()):
        for kind, spec in (("governed", smoke.governed_spec(api)),
                           ("served", smoke.served_spec(api))):
            assert canonical(config_doc(spec)) == canonical(
                entry[kind]["config"]), kind
    assert entry["governed"]["config"]["horizon"] == smoke.GOVERNED_HORIZON
    assert sorted(entry["governed"]["records"]) == ["g", "m", "r"]
    assert len(entry["served"]["records"]) == 7


def test_full_width_entries_are_whole(fixture):
    """Seven full-width runs at T=1024 and R=1,000,000 with every leaf,
    24 Figure 8 points, the records' parity fields."""
    runs = fixture["engine_full"]["runs"]
    assert len(runs) == 7 and len(fixture["fig8"]["points"]) == 24
    for name, run in runs.items():
        cfg = run["config"]
        assert (cfg["n_threads"], cfg["workload"]["n_rows"]) == \
            (1024, 1_000_000), name
        assert run["digests"]["rows.nt"][1] == [1_000_000]
        assert run["commits"] > 0
        assert len(run["digests"]) == len(
            next(iter(fixture["engine_mid"]["runs"].values()))["digests"])
    fields = set(INT_FIELDS + FLOAT_FIELDS)
    for p in fixture["fig8"]["points"].values():
        assert set(p["record"]) == fields
