"""The reference's sharded runs for the ``test_torch_mesh_*.py`` files (a
helper, not a test file).

:func:`start` writes the jobs of one test file to a pickle and runs
:data:`REF` on them in ONE subprocess (JAX's compiles dominate a file's
time) with four forced host devices in the subprocess's own environment
(the pytest process's stays as it is); the port's ranks run meanwhile, and
:func:`finish` collects the reference's results. Jobs:

``train``  ``[(arch, act, ds)]``: three steps of ``B x S`` from the weights
           of ``init_params`` at ``PRNGKey(0)`` and ``make_batch``'s batches
           of ``DataConfig(seed=0)`` on ``make_host_mesh(2)``: the smoke
           config's own activations at ``ds = 1`` through
           ``repro.launch.train.train(model_axis=2)`` itself, every other
           case through the same loop with ``act_dtype`` and
           ``moe_data_shards`` replaced. Returns the losses, whether the
           weights made on the mesh are the ones the port was given, and,
           in f32 activations, ``jax.grad`` of the first batch's loss at
           those weights on the mesh (``"grads"``).
``serve``  ``[(arch, ds)]``: prefill of all but the last position of
           ``d["serve_inputs"][arch]`` (``torch_mesh_worker.serve_inputs``:
           embeddings and M-RoPE streams for an embedding-input
           architecture) or else of ``d["tokens"]``, and one decode step of
           the last, f32 activations, weights placed by the ``serve`` rules;
           the logits, caches and next token.
``moe``    ``[(arch, ds, capacity_factor)]``: ``repro.models.moe.moe`` on
           the mesh (weights by the ``train`` rules, tokens over "data")
           and the gradient of ``sum(y * w) + 3 aux`` with respect to the
           weights and the tokens; out, ``MoEStats`` and grads.
``seqpar`` ``{"arch", "loss_chunk", "shapes"}``: the spec the reference's
           ``annotate(x, "batch", "model", None)`` (the residual's) gives an
           activation of each shape on the mesh, and the f32 loss of the
           first train batch with sequence-chunked CE at ``loss_chunk``
           (``"specs"``, ``"loss"``).
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig, init_state, make_batch
from repro.models import init_params as ref_init_params
from repro.models import lm_spec as ref_lm_spec

from torch_mesh_worker import jobs_rank, run_ranks, serve_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S = 3, 8, 32
SERVE_B, SERVE_S = 2, 16            # prompt; one more token is decoded
REF_TIMEOUT = 900
# the bars of tests/test_torch_mesh_train.py and _serve.py: f32 losses
# 1e-5 relative, bf16 2^-9 (one rounding of a bf16 value); f32 logits and
# caches 2e-4 (the models' bar); the MoE layer 1e-5
# (tests/test_torch_model_layers.py's)
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -9
SERVE_TOL = 2e-4
LAYER_TOL = 1e-5
# the first step's gradient in f32 activations, each leaf within this of
# its max |value| (the MoE layer's bar, ten times: a whole model's backward
# adds more reduction orders; a gradient that misses other ranks' shares
# is off by O(1))
GRAD_TOL = 1e-4

REF = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.data import DataConfig, init_state, make_batch
from repro.distributed import param_shardings
from repro.distributed.sharding import annotate, set_activation_mesh
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step
from repro.launch.train import train
from repro.models import decode_step, init_params, lm_spec, loss_fn, prefill
from repro.models.moe import moe, moe_spec
from repro.optim import adamw
with open(sys.argv[1], "rb") as f:
    d = pickle.load(f)
steps, B, S = d["shape"]
mesh = make_host_mesh(2)
out = {"train": {}, "same_weights": {}, "serve": {}, "moe": {}, "grads": {},
       "seqpar": {}}
for arch, act, ds in d["train"]:
    base = get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, act_dtype=act, moe_data_shards=ds)
    if act == "float32":
        with jax.set_mesh(mesh):
            params = jax.device_put(d["params"][arch], param_shardings(
                lm_spec(cfg), mesh, "train"))
            out["grads"][arch, act, ds] = jax.device_get(jax.jit(jax.grad(
                lambda p, b: loss_fn(p, cfg, b)[0]))(
                params, d["batches"][arch][0]))
    if cfg == base:
        out["train"][arch, act, ds] = train(arch, True, steps, B, S, None,
                                            model_axis=2, log_every=100)
        continue
    with jax.set_mesh(mesh):
        p_shard = param_shardings(lm_spec(cfg), mesh, "train")
        params = jax.jit(lambda k: init_params(lm_spec(cfg), k),
                         out_shardings=p_shard)(jax.random.PRNGKey(0))
        out["same_weights"][arch] = all(
            np.array_equal(np.asarray(a), b) for a, b in zip(
                jax.tree.leaves(params), jax.tree.leaves(d["params"][arch])))
        opt = adamw.init(params)
        dstate, dc = init_state(), DataConfig(seed=0)
        step = jax.jit(make_train_step(
            cfg, adamw.AdamWConfig(decay_steps=max(steps, 2))))
        losses = []
        for _ in range(steps):
            b, dstate = make_batch(dc, cfg, B, S, dstate)
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
    out["train"][arch, act, ds] = losses
set_activation_mesh(mesh)
with jax.set_mesh(mesh):
    sp = d.get("seqpar")
    if sp:
        specs = {shape: tuple(jax.jit(lambda x: annotate(
            x, "batch", "model", None))(jnp.zeros(shape, jnp.float32))
            .sharding.spec) for shape in sp["shapes"]}
        out["seqpar"]["specs"] = {             # trailing Nones kept
            shape: s + (None,) * (len(shape) - len(s))
            for shape, s in specs.items()}
        arch = sp["arch"]
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  act_dtype="float32", remat=True,
                                  loss_chunk=sp["loss_chunk"])
        params = jax.device_put(d["params"][arch], param_shardings(
            lm_spec(cfg), mesh, "train"))
        out["seqpar"]["loss"] = float(jax.jit(
            lambda p, b: loss_fn(p, cfg, b)[0])(
            params, d["batches"][arch][0]))
    for arch, ds in d["serve"]:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  act_dtype="float32", moe_data_shards=ds)
        params = jax.device_put(d["params"][arch], param_shardings(
            lm_spec(cfg), mesh, "serve"))
        inp = d["serve_inputs"].get(arch, {"tokens": d["tokens"]})
        n = d["tokens"].shape[1] - 1

        def part(sl):
            return {k: jnp.asarray(v[:, :, sl] if k == "positions3"
                                   else v[:, sl]) for k, v in inp.items()}
        lg, caches = jax.jit(lambda p, x: prefill(p, cfg, max_len=n + 1,
                                                  **x))(
            params, part(slice(0, n)))
        lg2, caches2 = jax.jit(lambda p, x, c: decode_step(
            p, cfg, caches=c, pos=jnp.asarray(n, jnp.int32), **x))(
            params, part(slice(n, n + 1)), caches)
        out["serve"][arch, ds] = dict(
            logits=np.asarray(lg), caches=jax.device_get(caches),
            next=np.asarray(jnp.argmax(lg2[:, -1], -1)),
            caches2=jax.device_get(caches2))
    for case, (p, x, w) in d["moe"].items():
        arch, ds, cf = case
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  act_dtype="float32", moe_data_shards=ds,
                                  capacity_factor=cf)
        p = jax.device_put(p, param_shardings(moe_spec(cfg), mesh, "train"))
        x = jax.device_put(x, NamedSharding(mesh, P("data")))

        def f(p, x):
            y, st = moe(p, x, cfg)
            return jnp.sum(y * w) + 3.0 * st.aux_loss, (y, st)
        (_, (y, st)), g = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
        out["moe"][case] = dict(
            y=np.asarray(y), aux=float(st.aux_loss),
            counts=np.asarray(st.expert_counts), dropped=int(st.dropped),
            grads=jax.device_get(g))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def weights(arch: str, key: int = 0):
    """The reference's smoke weights at ``PRNGKey(key)``, numpy leaves."""
    cfg = ref_get_config(arch, smoke=True)
    return jax.device_get(jax.jit(
        lambda k: ref_init_params(ref_lm_spec(cfg), k))(
        jax.random.PRNGKey(key)))


def batches(arch: str):
    """The reference's ``make_batch`` batches of ``DataConfig(seed=0)``,
    the ones its ``train`` feeds (numpy)."""
    cfg = ref_get_config(arch, smoke=True)
    dstate, dc, out = init_state(), DataConfig(seed=0), []
    for _ in range(STEPS):
        b, dstate = make_batch(dc, cfg, B, S, dstate)
        out.append({k: np.asarray(v) for k, v in b.items()})
    return out


def moe_inputs(arch: str, ds: int, cf: float, seed: int = 0):
    """One MoE layer's weights, tokens (4, 32, d) and loss weights, from a
    numpy generator (f32)."""
    cfg = ref_get_config(arch, smoke=True)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    rng = np.random.default_rng(seed)

    def w(*shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    p = {"router": w(d, E, fan_in=d), "wi_gate": w(E, d, ff, fan_in=d),
         "wi_up": w(E, d, ff, fan_in=d), "wo": w(E, ff, d, fan_in=ff)}
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        p["shared"] = {"wi_gate": w(d, sf, fan_in=d),
                       "wi_up": w(d, sf, fan_in=d), "wo": w(sf, d, fan_in=sf)}
    x = rng.normal(size=(4, 32, d)).astype(np.float32)
    return p, x, rng.normal(size=(4, 32, d)).astype(np.float32)


def start(tmp, train=(), serve=(), moe=(), seqpar=None):
    """Write the jobs (and the weights, batches and inputs they need) and
    start the reference's subprocess; returns ``(path, process)``."""
    tokens = np.random.default_rng(3).integers(
        0, 256, (SERVE_B, SERVE_S + 1)).astype(np.int32)
    sp_archs = {seqpar["arch"]} if seqpar else set()
    archs = {a for a, *_ in train} | {a for a, _ in serve} | sp_archs
    cfgs = {a: ref_get_config(a, smoke=True) for a, _ in serve}
    d = {"shape": (STEPS, B, S), "train": list(train), "serve": list(serve),
         "params": {a: weights(a) for a in sorted(archs)},
         "batches": {a: batches(a) for a in
                     {a for a, *_ in train} | sp_archs},
         "seqpar": seqpar,
         "moe": {case: moe_inputs(*case) for case in moe},
         "tokens": tokens,
         "serve_inputs": {a: serve_inputs(c, SERVE_B, SERVE_S + 1)
                          for a, c in cfgs.items() if not c.embed_inputs}}
    path = str(tmp / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump(d, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", REF, path,
                             str(tmp / "ref.pkl")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return path, proc


def finish(tmp, proc):
    """The reference's results, once its subprocess has ended."""
    _, stderr = proc.communicate(timeout=REF_TIMEOUT)
    assert proc.returncode == 0, stderr[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        return pickle.load(f)


def rel(a, b) -> float:
    """max |a - b| over max |b|."""
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - b).max()
                 / (np.abs(b).max() + 1e-12))


def run(tmp, train=(), serve=(), moe=(), seqpar=None, rank_fn=jobs_rank):
    """The jobs on the port's 2 x 2 gloo mesh (four spawned ranks, each
    running ``rank_fn(rank, path, 2)``) while the reference's subprocess
    runs them: (every rank's results, the reference's)."""
    path, proc = start(tmp, train, serve, moe, seqpar)
    got = run_ranks(rank_fn, 4, path, 2)
    return got, finish(tmp, proc)


def check_train(runs, job):
    """Every rank's losses of ``job`` equal; rank 0's against the
    reference's at the job's activation bar. Every rank's parameters after
    the steps equal rank 0's, bit for bit (a replicated parameter takes
    the same update on every rank). In f32 activations, every rank's
    gradient of the first step against the reference's, leaf by leaf."""
    got, want = runs
    runs_ = [rank["train"][job] for rank in got]
    losses = [r["losses"] for r in runs_]
    assert all(g == losses[0] for g in losses)
    assert len(want["train"][job]) == STEPS
    tol = F32_TOL if job[1] == "float32" else BF16_TOL
    np.testing.assert_allclose(losses[0], want["train"][job], rtol=tol)
    first = jax.tree.leaves(runs_[0]["params"])
    for r in runs_[1:]:
        ps = jax.tree.leaves(r["params"])
        assert len(ps) == len(first)
        assert all(np.array_equal(a, b) for a, b in zip(ps, first))
    if job[1] != "float32":
        return
    wg = jax.tree.leaves(want["grads"][job])
    for r in runs_:
        gs = jax.tree.leaves(r["grads"])
        assert len(gs) == len(wg)
        for a, b in zip(gs, wg):
            assert a.shape == np.shape(b)
            assert rel(a, b) < GRAD_TOL


def check_serve(runs, key):
    """``key`` ``(arch, ds, kernel)``: every rank's prefill logits, caches
    after prefill and after the decode step, and next token against the
    reference's."""
    got, want = runs
    w = want["serve"][key[:2]]
    for r, rank in enumerate(got):
        g = rank["serve"][key]
        assert g["logits"].shape == np.shape(w["logits"])
        assert rel(g["logits"], w["logits"]) < SERVE_TOL, r
        for name in ("caches", "caches2"):
            xs, ys = jax.tree.leaves(w[name]), jax.tree.leaves(g[name])
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                np.testing.assert_allclose(y, np.asarray(x, np.float32),
                                           rtol=SERVE_TOL, atol=SERVE_TOL)
        np.testing.assert_array_equal(g["next"], w["next"])


def check_moe(runs, case):
    """``case`` ``(arch, ds, capacity_factor)``: every rank's MoE layer
    output, aux loss and gradients within the layer bar of the reference's,
    its counts and drops equal, its gradients in their weights'
    placements."""
    got, want = runs
    w = want["moe"][case]
    assert w["dropped"] > 0 or case[2] > 1, "the case drops assignments"
    for rank in got:
        g = rank["moe"][case]
        np.testing.assert_array_equal(g["counts"], w["counts"])
        assert g["dropped"] == w["dropped"]
        assert rel(g["y"], w["y"]) < LAYER_TOL
        assert abs(g["aux"] - w["aux"]) <= LAYER_TOL * abs(w["aux"])
        wg = jax.tree.leaves(w["grads"])
        assert len(wg) == len(g["grads"])
        for a, b in zip(g["grads"], wg):
            assert rel(a, b) < LAYER_TOL
        assert g["placed"]
