"""Sweep lanes across devices (``run_sweep(shard=True, devices=[...])``):
three CPU shards, one spawned worker process each, so that no pack's lanes
divide evenly over the devices. Every lane equals the unsharded run bit for
bit, with compaction and without it, and equals the reference's
``run_sweep`` sharded over three forced host devices (a subprocess with
``XLA_FLAGS`` in its own environment). The lane split follows the
reference's ``_shard_lanes``: the port's device blocks hold the lanes that
the reference's lane-axis shards hold there, for every lane count from 1
to 9.

Cut for the time limit: horizons of 4,000 ticks, T <= 24.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import pytest
import torch

from repro.core.lock import (CostModel as RefCostModel,
                             WorkloadSpec as RefWorkloadSpec)
from repro.sweep.grid import SweepPoint as RefSweepPoint
from repro_torch.core.lock import WorkloadSpec
from repro_torch.sweep import grid, point, run_sweep
from repro_torch.sweep import runner as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOT = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=512)
ZIPF = WorkloadSpec(kind="zipf", txn_len=2, n_rows=256, zipf_s=0.9)
HORIZON = 4_000
SHARDS = ["cpu"] * 3
LANES = range(1, 10)

REF = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.sweep import run_sweep
from repro.sweep import runner as R
assert len(jax.devices()) == 3
with open(sys.argv[1], "rb") as f:
    d = pickle.load(f)
blocks = {}
for n in d["lanes"]:
    x, g = R._shard_lanes(jnp.arange(n), n)
    shards = sorted(x.addressable_shards, key=lambda s: s.device.id)
    blocks[n] = (g, [np.asarray(s.data).tolist() for s in shards])
res = run_sweep(d["points"])
with open(sys.argv[2], "wb") as f:
    pickle.dump({"blocks": blocks,
                 "metrics": {k: v.__dict__ for k, v in res.metrics.items()},
                 "widths": [b.n_chunks for b in res.buckets]}, f)
"""


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points():
    """Buckets of 8 (T <= 64), 4 (aria) and 3 (T = 100, padded to 128)
    lanes: none divides by three shards."""
    return (grid(["mysql", "o2", "group", "bamboo"], HOT, [4, 8],
                 horizon=HORIZON)
            + grid("aria", ZIPF, [8, 12, 16, 24], horizon=HORIZON)
            + grid(["o1", "group", "brook2pl"], ZIPF, 100,
                   horizon=HORIZON // 2)
            + [point("bamboo", ZIPF, 12, horizon=3_000, drain=True,
                     name="drain_bamboo")])


def _ref_points(pts):
    return [RefSweepPoint(
        **{**dataclasses.asdict(p),
           "workload": RefWorkloadSpec(**dataclasses.asdict(p.workload)),
           "costs": RefCostModel(**dataclasses.asdict(p.costs))})
        for p in pts]


def test_lane_split_follows_the_reference_rule():
    assert R._shard_lanes(5, 1) == ([[0, 1, 2, 3, 4]], 5)
    assert R._shard_lanes(5, 3) == ([[0, 1], [2, 3], [4, 4]], 6)
    assert R._shard_lanes(8, 3) == ([[0, 1, 2], [3, 4, 5], [6, 7, 7]], 9)
    shares = R._split(_points(), "pow2", 3)
    names = sorted(p.name for s in shares for p in s)
    assert names == sorted(p.name for p in _points())    # pads never run
    assert sorted(len(s) for s in shares) == [5, 5, 6]


def test_three_shards_equal_one_device_and_the_reference(tmp_path):
    pts = _points()
    path = str(tmp_path / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump({"points": _ref_points(pts), "lanes": list(LANES)}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=3")
    ref = subprocess.Popen([sys.executable, "-c", REF, path,
                            str(tmp_path / "ref.pkl")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    for compact in (True, False):
        one = run_sweep(pts, chunk_size=4, compact=compact, device="cpu")
        got = run_sweep(pts, chunk_size=4, compact=compact, device="cpu",
                        devices=SHARDS)
        assert got.names() == one.names()
        for p in pts:
            assert got[p.name].__dict__ == one[p.name].__dict__, p.name
        assert sum(b.n_points for b in got.buckets) == len(pts)
        assert got.n_compiles == 0
    _, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-3000:]
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    for p in pts:
        assert got[p.name].__dict__ == want["metrics"][p.name], p.name
    for n in LANES:
        blocks, g = R._shard_lanes(n, len(SHARDS))
        assert (g, blocks) == tuple(want["blocks"][n]), n
