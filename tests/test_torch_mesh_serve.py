"""Tensor-parallel serving of the port on a 2 x 2 mesh of four gloo ranks
(spawned processes, ``tests/torch_mesh_worker.py``) against the reference
on ``repro.launch.mesh.make_host_mesh(2)`` over four forced host devices (a
subprocess with ``XLA_FLAGS`` in its own environment): prefill and decode
of qwen2-0.5b and gemma3-12b (local layers' ring caches) at their smoke
configs in f32, weights placed by the ``serve`` rules, within the models'
bar (2e-4 relative, logits and caches), on the plain path and on the
kernel path (the flash wrapper on each rank's local heads; on the CPU it
runs its plain version). Then a ``GroupServer`` on the mesh token for
token against one device, the kernel wrappers' refusal of DTensors, and
the placements: ``arange`` tensors placed by the port's shardings hold on
every mesh coordinate the shard JAX's ``NamedSharding`` gives the same
spec there.

Cut for the time limit: B = 2, S = 12 (+1 decoded), one decode step.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import param_pspecs as ref_param_pspecs
from repro.models import init_params as ref_init_params
from repro.models import lm_spec as ref_lm_spec
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import param_pspecs
from repro_torch.models import lm_spec
from repro_torch.models.common import tree_map_specs
from torch_mesh_worker import run_ranks, serve_rank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-0.5b", "gemma3-12b")
B, S = 2, 12
TOL = 2e-4
MESH = {"data": 2, "model": 2}

REF = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed import param_shardings
from repro.distributed.sharding import set_activation_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import decode_step, lm_spec, prefill
with open(sys.argv[1], "rb") as f:
    d = pickle.load(f)
mesh = make_host_mesh(2)
set_activation_mesh(mesh)
out = {}
S = d["tokens"].shape[1] - 1
with jax.set_mesh(mesh):
    for arch, tree in d["params"].items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  act_dtype="float32")
        params = jax.device_put(tree, param_shardings(lm_spec(cfg), mesh,
                                                      "serve"))
        toks = jnp.asarray(d["tokens"])
        lg, caches = jax.jit(lambda p, t: prefill(p, cfg, tokens=t,
                                                  max_len=S + 1))(
            params, toks[:, :S])
        lg2, caches2 = jax.jit(lambda p, t, c: decode_step(
            p, cfg, tokens=t, caches=c, pos=jnp.asarray(S, jnp.int32)))(
            params, toks[:, S:], caches)
        out[arch] = dict(logits=np.asarray(lg), caches=jax.device_get(caches),
                         next=np.asarray(jnp.argmax(lg2[:, -1], -1)),
                         caches2=jax.device_get(caches2))
    shards = {}
    for name, (shape, spec) in d["specs"].items():
        x = jax.device_put(jnp.arange(int(np.prod(shape)), dtype=jnp.int32)
                           .reshape(shape), NamedSharding(mesh, P(*spec)))
        for sh in x.addressable_shards:
            coord = tuple(int(c) for c in np.argwhere(
                mesh.devices == sh.device)[0])
            shards[name, coord] = np.asarray(sh.data)
    out["shards"] = shards
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ref_weights(arch):
    cfg = ref_get_config(arch, smoke=True)
    params = jax.jit(lambda k: ref_init_params(ref_lm_spec(cfg), k))(
        jax.random.PRNGKey(7))
    return jax.device_get(params)


def _spec_cases():
    """Every distinct (shape, spec) of the smoke parameters of qwen2-0.5b
    and deepseek-v2-lite-16b (MLA + MoE) under the train and serve rules on
    the 2 x 2 mesh, the reference's stacked spec without its layers axis
    (equal to the port's, checked here too)."""
    from jax.sharding import AbstractMesh
    amesh = AbstractMesh((2, 2), ("data", "model"))
    cases = {}
    for arch in ("qwen2-0.5b", "deepseek-v2-lite-16b"):
        cfg = get_config(arch, smoke=True)
        for mode in ("train", "serve"):
            port = param_pspecs(lm_spec(cfg), MESH, mode)
            shapes = tree_map_specs(lambda s: s.shape, lm_spec(cfg))
            ref = ref_param_pspecs(ref_lm_spec(ref_get_config(
                arch, smoke=True)), amesh, mode)
            for spec, shape, want in _pairs(port, shapes, ref):
                assert spec == want, (arch, mode, spec, want)
                cases[f"{shape}{spec}"] = (shape, spec)
    return cases


def _norm(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, tuple) else e) for e in spec)


def _pairs(port, shapes, ref, stacked=False):
    if isinstance(port, dict):
        for k in port:
            yield from _pairs(port[k], shapes[k], ref[k],
                              stacked or k == "blocks")
    elif isinstance(port, list):
        for p, s in zip(port, shapes):
            yield from _pairs(p, s, ref, stacked)
    else:
        want = _norm(tuple(ref) + (None,) * (len(shapes) + stacked
                                             - len(tuple(ref))))
        yield port, shapes, want[1:] if stacked else want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and the reference's subprocess, run once for the
    file: (every rank's results, the reference's)."""
    tmp = tmp_path_factory.mktemp("mesh_serve")
    tokens = np.random.default_rng(3).integers(
        0, 256, (B, S + 1)).astype(np.int32)
    path = str(tmp / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {a: _ref_weights(a) for a in ARCHS},
                     "tokens": tokens, "specs": _spec_cases()}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", REF, path,
                            str(tmp / "ref.pkl")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    got = run_ranks(serve_rank, 4, path, 2)
    _, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        return got, pickle.load(f)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_match_reference(runs, arch, kernel):
    got, want = runs
    w = want[arch]
    for r, rank in enumerate(got):
        g = rank[arch, kernel]
        a, b = np.asarray(w["logits"], np.float32), g["logits"]
        assert a.shape == b.shape
        rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-6)
        assert rel < TOL, (r, rel)
        for key in ("caches", "caches2"):
            xs, ys = jax.tree.leaves(w[key]), jax.tree.leaves(g[key])
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                np.testing.assert_allclose(y, np.asarray(x, np.float32),
                                           rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(g["next"], w["next"])


def test_group_server_on_the_mesh_equals_one_device(runs):
    for rank in runs[0]:
        assert rank["server"][True] == rank["server"][False]


def test_kernel_wrappers_refuse_dtensors(runs):
    for rank in runs[0]:
        assert rank["refused"] == [True, True]


def test_placements_hold_the_shards_jax_gives_the_same_spec(runs):
    got, want = runs
    for coord, shards in (rank["placed"] for rank in got):
        for name, x in shards.items():
            np.testing.assert_array_equal(x, want["shards"][name, coord],
                                          err_msg=f"{name} at {coord}")
    assert sorted(r["placed"][0] for r in got) == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
