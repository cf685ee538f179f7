"""FSDP+TP training of the port on a 2 x 2 mesh of four gloo ranks (spawned
processes, ``tests/torch_mesh_worker.py``) against the reference's
``repro.launch.train.train("qwen2-0.5b", True, 3, 8, 32, None,
model_axis=2)`` on four forced host devices (a subprocess with ``XLA_FLAGS``
in its own environment; its mesh is ``make_host_mesh(2)``'s), on the same
weights (the reference's ``init_params`` at ``PRNGKey(0)``) and batches
(its ``make_batch`` from ``DataConfig(seed=0)``).

Bars. In f32 activations (both packages' train loop rerun with
``act_dtype="float32"``) the losses agree within 1e-5 relative, the loss bar
of ``tests/torch_train_parity.py``. At the smoke config's bf16 activations
the reference's own losses are 6.104712, 6.094141 and 6.090685; the port's
sharded ones agree within 2^-9 relative, one rounding of a bf16 value
(8 significant bits): the two packages round their bf16 activations in
different orders, so the bf16 losses are held to bf16's own resolution.

Cut for the time limit: three steps.
"""
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig, init_state, make_batch
from repro.models import init_params as ref_init_params
from repro.models import lm_spec as ref_lm_spec
from torch_mesh_worker import run_ranks, train_rank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S = 3, 8, 32
REF_LOSSES = [6.104712, 6.094141, 6.090685]
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -9

REF = """
import dataclasses, json, pickle, sys
import jax, numpy as np
from repro.configs import get_config
from repro.data import DataConfig, init_state, make_batch
from repro.distributed import param_shardings
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step
from repro.launch.train import train
from repro.models import init_params, lm_spec
from repro.optim import adamw
steps, B, S = %d, %d, %d
out = {"bfloat16": train("qwen2-0.5b", True, steps, B, S, None,
                         model_axis=2)}
mesh = make_host_mesh(2)
cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                          act_dtype="float32")
with open(sys.argv[1], "rb") as f:
    d = pickle.load(f)
with jax.set_mesh(mesh):
    p_shard = param_shardings(lm_spec(cfg), mesh, "train")
    params = jax.jit(lambda k: init_params(lm_spec(cfg), k),
                     out_shardings=p_shard)(jax.random.PRNGKey(0))
    # the weights this process made on its mesh are the ones the test
    # carried over
    same = all(np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(d["params"])))
    opt = adamw.init(params)
    dstate, dc = init_state(), DataConfig(seed=0)
    step = jax.jit(make_train_step(cfg, adamw.AdamWConfig(**d["opt"])))
    losses = []
    for _ in range(steps):
        b, dstate = make_batch(dc, cfg, B, S, dstate)
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
out["float32"] = losses
out["same_weights"] = same
print(json.dumps(out))
""" % (STEPS, B, S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and the reference's subprocess, run once for the
    file: (every rank's losses, the reference's)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    cfg = ref_get_config("qwen2-0.5b", smoke=True)
    params = jax.device_get(jax.jit(
        lambda k: ref_init_params(ref_lm_spec(cfg), k))(jax.random.PRNGKey(0)))
    dstate, dc, batches = init_state(), DataConfig(seed=0), []
    for _ in range(STEPS):
        b, dstate = make_batch(dc, cfg, B, S, dstate)
        batches.append({k: np.asarray(v) for k, v in b.items()})
    path = str(tmp / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batches": batches,
                     "opt": {"decay_steps": STEPS}}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", REF, path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    got = run_ranks(train_rank, 4, path, 2)
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-3000:]
    return got, json.loads(stdout.strip().splitlines()[-1])


def test_reference_reproduces_its_sharded_train(runs):
    """The reference's train(model_axis=2) on its own mesh, from the weights
    this test carried over to the port."""
    want = runs[1]
    assert want["same_weights"]
    assert want["bfloat16"] == pytest.approx(REF_LOSSES, abs=5e-7)


def test_every_rank_reports_the_same_losses(runs):
    got = runs[0]
    assert all(g == got[0] for g in got)


@pytest.mark.parametrize("act, tol", [("float32", F32_TOL),
                                      ("bfloat16", BF16_TOL)])
def test_fsdp_tp_train_matches_reference(runs, act, tol):
    got, want = runs
    np.testing.assert_allclose(got[0][act], want[act], rtol=tol)
