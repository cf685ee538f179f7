"""Ranks of the port's sharded runs over gloo (a helper of the
``test_torch_mesh_*.py`` files, run in spawned processes; imports no JAX).

:func:`run_ranks` starts ``world`` spawned processes, each of which joins a
gloo group at a free port, runs one of the ``*_rank`` functions below and
leaves the group again; the pytest process itself never initialises a
process group or writes its environment.
"""
import multiprocessing
import pickle
import socket
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

CPU = "cpu"
RANK_TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        return fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args):
    """``fn(rank, *args)`` on ``world`` gloo ranks; returns every rank's
    result, in rank order."""
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(world, mp_context=ctx) as pool:
        futs = [pool.submit(_rank_main, fn, r, world, port, args)
                for r in range(world)]
        return [f.result(timeout=RANK_TIMEOUT) for f in futs]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------- training

def _place(tree, shardings, mesh):
    """``tree`` placed by ``shardings(mesh)`` on a mesh; as it is on one
    device (``mesh`` None)."""
    from repro_torch.distributed.sharding import distribute
    return tree if mesh is None else distribute(tree, shardings(mesh))


def _host_tree(tree):
    """A port parameter tree (DTensors whole) in the reference's stacked
    layout, numpy leaves."""
    from repro_torch import tree as tr
    from repro_torch.launch.steps import whole
    from repro_torch.models.convert import params_to_numpy
    return params_to_numpy(tr.unflatten(tree, [whole(t) for t in
                                               tr.leaves(tree)]))


def _sharded_train(tree, batches, cfg, opt_kw, mesh, grads=False):
    """The port's ``make_train_step`` on ``mesh`` (None: one device) from
    the reference's weights (numpy, stacked) over its batches (numpy):
    ``{"losses", "params"}`` (the parameters after the steps, whole, in the
    reference's layout) and, with ``grads``, ``"grads"``: the gradient of
    the first batch's loss at the given weights, whole, alike."""
    from repro_torch.distributed.sharding import (batch_shardings, on_mesh,
                                                  param_shardings)
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import lm_spec
    from repro_torch.models.convert import _tensor, params_from_numpy
    from repro_torch.optim import adamw
    params = _place(params_from_numpy(tree, device=CPU),
                    lambda m: param_shardings(lm_spec(cfg), m, "train"), mesh)
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(**opt_kw), device=CPU,
                           mesh=mesh)
    out = {"losses": []}
    for i, b in enumerate(batches):
        b = {k: _tensor(v, CPU) for k, v in b.items()}      # bf16 embeds
        b = _place(b, lambda m: batch_shardings(b, m, {"positions3": 1}),
                   mesh)
        if grads and i == 0:
            with on_mesh(mesh):
                g = value_and_grad(params, cfg, b, device=CPU)[2]
                out["grads"] = _host_tree(g)
        params, opt, m = step(params, opt, b)
        out["losses"].append(float(m["loss"]))
    out["params"] = _host_tree(params)
    return out


def _train_jobs(d, mesh):
    """Each ``(arch, act, ds)`` of ``d["train"]`` through the port's
    ``make_train_step`` on ``mesh`` (None: one device), activations ``act``
    and ``moe_data_shards`` ``ds``, on the weights and batches of ``d``;
    ``{job: _sharded_train's result}``, with the first step's gradient in
    f32 activations."""
    import dataclasses
    from repro_torch.configs import get_config
    out = {}
    for arch, act, ds in d["train"]:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  act_dtype=act, moe_data_shards=ds)
        batches = d["batches"][arch]
        out[arch, act, ds] = _sharded_train(
            d["params"][arch], batches, cfg,
            {"decay_steps": max(len(batches), 2)}, mesh,
            grads=act == "float32")
    return out


def restart_rank(rank, ckpt_root, model_axis):
    """``train()`` on the mesh: four steps straight, then two steps and a
    fresh ``train()`` that resumes from their checkpoint; the losses of the
    three, and this rank's parameters after the straight run's and the
    resumed run's last step (whole, in the reference's layout), as the
    train step handed them back to ``train()``."""
    from repro_torch.launch import train as loop
    kw = dict(arch="qwen2-0.5b", smoke=True, batch=8, seq=32, ckpt_every=2,
              model_axis=model_axis, device=CPU, log_every=100)
    last, make = {}, loop.make_train_step

    def recorded(*args, **kwargs):          # this process's train() only
        step = make(*args, **kwargs)

        def run(*xs):
            out = step(*xs)
            last["params"] = out[0]
            return out
        return run
    loop.make_train_step = recorded
    full = loop.train(steps=4, ckpt_dir=f"{ckpt_root}/a", **kw)
    p_full = _host_tree(last["params"])
    first = loop.train(steps=2, ckpt_dir=f"{ckpt_root}/b", **kw)
    rest = loop.train(steps=4, ckpt_dir=f"{ckpt_root}/b", **kw)
    return full, first, rest, p_full, _host_tree(last["params"])


# ---------------------------------------------------------------- serving

def _numpy_tree(tree):
    from repro_torch.launch.steps import whole
    from repro_torch.models.convert import caches_to_numpy
    return caches_to_numpy({g: {u: [type(c)(*(whole(t) for t in c))
                                    for c in layers]
                                for u, layers in gt.items()}
                            for g, gt in tree.items()})


def serve_inputs(cfg, batch: int, n: int, seed: int = 3) -> dict:
    """numpy inputs of ``n`` positions for a serving job of ``cfg`` (either
    package's config): token ids below 256, or for an embedding-input
    architecture f32 embeddings; with M-RoPE also its three position
    streams (distinct, sorted)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        d = {"tokens": rng.integers(0, 256, (batch, n)).astype(np.int32)}
    else:
        d = {"embeds": rng.normal(size=(batch, n, cfg.d_model))
             .astype(np.float32)}
    if cfg.mrope:
        d["positions3"] = np.sort(rng.integers(0, 3 * n, (3, batch, n)),
                                  axis=-1).astype(np.int32)
    return d


def cut_inputs(inputs: dict, sl: slice) -> dict:
    """The positions ``sl`` of :func:`serve_inputs`' inputs (numpy,
    contiguous)."""
    return {k: np.ascontiguousarray(v[:, :, sl] if k == "positions3"
                                    else v[:, sl])
            for k, v in inputs.items()}


def _prefill_decode(tree, cfg, inputs, mesh, kernel: bool):
    """Tensor-parallel prefill of all but the last position of ``inputs``
    (:func:`serve_inputs`: tokens, or embeddings with their M-RoPE
    streams) and one decode step of the last (f32 activations, the
    reference's weights ``tree`` placed by the ``serve`` rules, or on one
    device with ``mesh`` None; ``kernel``: the flash wrapper's path); the
    whole logits, caches and next token, numpy."""
    import dataclasses
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, whole)
    from repro_torch.models import lm_spec
    from repro_torch.models.convert import params_from_numpy
    cfg = dataclasses.replace(cfg, act_dtype="float32")
    params = _place(params_from_numpy(tree, device=CPU),
                    lambda m: param_shardings(lm_spec(cfg), m, "serve"),
                    mesh)
    S = next(v.shape[1] for k, v in inputs.items() if k != "positions3") - 1

    def part(sl):
        return {k: torch.from_numpy(v)
                for k, v in cut_inputs(inputs, sl).items()}
    pre = make_prefill_step(cfg, use_kernel=kernel, max_len=S + 1,
                            device=CPU, mesh=mesh)
    logits, caches = pre(params, part(slice(0, S)))
    serve = make_serve_step(cfg, device=CPU, mesh=mesh)
    nxt, caches2 = serve(params, {**part(slice(S, S + 1)), "caches": caches,
                                  "pos": S})
    return dict(logits=whole(logits).numpy(), caches=_numpy_tree(caches),
                next=whole(nxt).numpy(), caches2=_numpy_tree(caches2))


def _serve_jobs(d, mesh):
    """:func:`_prefill_decode` for each ``(arch, ds)`` of ``d["serve"]`` at
    ``moe_data_shards`` ``ds`` on ``d["serve_inputs"][arch]`` (by default
    ``d["tokens"]``), on the plain path and, for an architecture with
    global attention layers, on the kernel path;
    ``{(arch, ds, kernel): result}``."""
    import dataclasses
    from repro_torch.configs import get_config
    out = {}
    for arch, ds in d["serve"]:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  moe_data_shards=ds)
        has_global = any(m == "global" for unit, _ in cfg.layout
                         for m, _ in unit)
        for kernel in (False, True) if has_global else (False,):
            out[arch, ds, kernel] = _prefill_decode(
                d["params"][arch], cfg, d.get("serve_inputs", {}).get(
                    arch, {"tokens": d["tokens"]}), mesh, kernel)
    return out


def _moe_jobs(d, mesh, rules="train"):
    """Each case ``(arch, ds, capacity_factor)`` of ``d["moe"]``: the
    port's MoE layer on the mesh (weights by the ``rules``, tokens over
    "data"; ``mesh`` None: one device), its output, ``MoEStats`` and the
    gradient of ``sum(y * w) + 3 aux`` with respect to the weights and the
    tokens, whole; and whether the routed experts' and the router's
    gradients came back in their weights' placements."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (Sharding, on_mesh,
                                                  param_shardings)
    from repro_torch.launch.steps import whole
    from repro_torch.models.moe import moe, moe_spec
    out = {}
    for case, (p, x, w) in d["moe"].items():
        arch, ds, cf = case
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  act_dtype="float32", moe_data_shards=ds,
                                  capacity_factor=cf)
        p = _place(tree.unflatten(p, [torch.from_numpy(a) for a in
                                      tree.leaves(p)]),
                   lambda m: param_shardings(moe_spec(cfg), m, rules), mesh)
        leaves = [t.detach().requires_grad_(True) for t in tree.leaves(p)]
        x, w = torch.from_numpy(x), torch.from_numpy(w)
        if mesh is not None:
            xs = Sharding(mesh, ("data", None, None))
            x, w = xs.place(x), xs.place(w)
        x.requires_grad_(True)
        with on_mesh(mesh):
            y, st = moe(tree.unflatten(p, leaves), x, cfg)
            loss = (y * w).sum() + 3.0 * st.aux_loss
            grads = torch.autograd.grad(loss, leaves + [x])
        gtree = tree.unflatten(p, list(grads[:-1]))
        out[case] = dict(
            y=whole(y).detach().numpy(), aux=float(whole(st.aux_loss)),
            counts=whole(st.expert_counts).numpy(),
            dropped=int(whole(st.dropped)),
            grads=[whole(g).numpy() for g in grads],
            placed=mesh is None or all(
                gtree[k].placements == p[k].placements
                for k in ("router", "wi_gate", "wi_up", "wo")))
    return out


def jobs_rank(rank, path, model_axis, moe_rules="train"):
    """The jobs of ``tests/torch_mesh_ref.py``'s pickle ``path`` on the
    port's ``(world // model_axis, model_axis)`` mesh:
    ``{"train": ..., "serve": ..., "moe": ...}`` (see ``_train_jobs``,
    ``_serve_jobs``, ``_moe_jobs``)."""
    from repro_torch.launch.mesh import make_host_mesh
    return run_jobs(_load(path), make_host_mesh(model_axis), moe_rules)


def run_jobs(d, mesh, moe_rules="train"):
    """The jobs of ``d`` on ``mesh`` (None: one device), the MoE layer's
    weights placed by ``moe_rules``."""
    return {"train": _train_jobs(d, mesh), "serve": _serve_jobs(d, mesh),
            "moe": _moe_jobs(d, mesh, moe_rules)}


def spec_of(x):
    """A DTensor's placements as a spec (an entry a dimension: None, a
    mesh axis name, or a tuple of them in the mesh's order), the
    reference's ``PartitionSpec`` entries; None for a plain tensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return None
    names = x.device_mesh.mesh_dim_names
    out = []
    for d in range(x.dim()):
        axes = tuple(n for n, p in zip(names, x.placements)
                     if p.is_shard(d))
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


class ResidualProbe:
    """While active, records the residual at every block's entry
    (``transformer.block_apply``: mode, local shape, spec) and the input
    each remat checkpoint of a unit keeps (``transformer.checkpoint``)."""

    def __enter__(self):
        from repro_torch.models import transformer
        self.blocks, self.saved = [], []
        self._mod = transformer
        self._orig = transformer.block_apply, transformer.checkpoint
        block_apply, checkpoint = self._orig

        def local(x):
            return tuple(getattr(x, "_local_tensor", x).shape)

        def probed_block(p, x, cfg, kind, mode, **kw):
            self.blocks.append((mode, local(x), spec_of(x)))
            return block_apply(p, x, cfg, kind, mode, **kw)

        def probed_checkpoint(fn, x, *args, **kw):
            self.saved.append((local(x), spec_of(x)))
            return checkpoint(fn, x, *args, **kw)
        transformer.block_apply = probed_block
        transformer.checkpoint = probed_checkpoint
        return self

    def __exit__(self, *exc):
        self._mod.block_apply, self._mod.checkpoint = self._orig


def seqpar_rank(rank, path, model_axis):
    """:func:`run_seqpar` on the jobs of ``tests/torch_mesh_ref.py``'s
    pickle ``path`` on the port's ``(world // model_axis, model_axis)``
    mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    return run_seqpar(_load(path), make_host_mesh(model_axis))


def run_seqpar(d, mesh):
    """The sequence-parallel residual on ``mesh`` (None: one device), for
    ``tests/test_torch_mesh_seqpar.py``: with ``d["seqpar"]``'s arch (f32
    activations, remat, chunked CE at its ``loss_chunk``) the first batch's
    loss and what each unit's checkpoint keeps (``value_and_grad``); the
    prompt's prefill and decode (:func:`_prefill_decode`) with the residual
    at each block's entry, as given and cut by one position (an odd
    length); on a mesh, the collectives of one FSDP+TP step of each of
    ``d["seqpar"]["collectives"]``' smoke archs
    (:func:`step_collectives`)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (batch_shardings, on_mesh,
                                                  param_shardings)
    from repro_torch.launch.steps import value_and_grad, whole
    from repro_torch.models import lm_spec
    from repro_torch.models.convert import _tensor, params_from_numpy
    sp = d["seqpar"]
    arch = sp["arch"]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              act_dtype="float32", remat=True,
                              loss_chunk=sp["loss_chunk"])
    params = _place(params_from_numpy(d["params"][arch], device=CPU),
                    lambda m: param_shardings(lm_spec(cfg), m, "train"),
                    mesh)
    b = {k: _tensor(v, CPU) for k, v in d["batches"][arch][0].items()}
    b = _place(b, lambda m: batch_shardings(b, m), mesh)
    with ResidualProbe() as train_probe, on_mesh(mesh):
        loss = float(whole(value_and_grad(params, cfg, b, device=CPU)[0]))
    out = {"loss": loss, "saved": train_probe.saved, "serve": {}}
    scfg = get_config(arch, smoke=True)
    inputs = d.get("serve_inputs", {}).get(arch, {"tokens": d["tokens"]})
    n = d["tokens"].shape[1]
    for name, sl in (("even", slice(0, n)), ("odd", slice(0, n - 1))):
        with ResidualProbe() as probe:
            res = _prefill_decode(d["params"][arch], scfg,
                                  cut_inputs(inputs, sl), mesh, False)
        out["serve"][name] = dict(res, blocks=probe.blocks)
    out["collectives"] = {} if mesh is None else {
        a: step_collectives(a, mesh, *sp["step_shape"])
        for a in sp["collectives"]}
    return out


def serve_rank(rank, path, model_axis):
    """Tensor-parallel prefill and decode on the reference's weights (f32
    activations), the plain and the kernel path (on the CPU the kernel
    wrapper runs its plain version on each rank's local heads); the whole
    logits and caches. Then a GroupServer on the mesh, the kernel
    wrappers' refusal of DTensors, and the placements of ``d["specs"]``
    (:func:`placements_of`)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import distribute, param_shardings
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_scatter import segment_sums
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import GroupServer, Request
    from repro_torch.models import lm_spec
    from repro_torch.models.convert import params_from_numpy
    d = _load(path)
    mesh = make_host_mesh(model_axis)
    out = {}
    for arch, tree in d["params"].items():
        for kernel in (False, True):
            out[arch, kernel] = _prefill_decode(
                tree, get_config(arch, smoke=True), {"tokens": d["tokens"]},
                mesh, kernel)
    # GroupServer on the mesh against one device (f32 activations: bf16
    # logits of the smoke vocabulary tie, and a tie's argmax follows the
    # last bit)
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              act_dtype="float32")
    tree = d["params"]["qwen2-0.5b"]
    tokens = {}
    for m in (None, mesh):
        params = params_from_numpy(tree, device=CPU)
        if m is not None:
            params = distribute(params, param_shardings(lm_spec(cfg), m,
                                                        "serve"))
        srv = GroupServer(cfg, params, batch_slots=4, max_len=32,
                          device=CPU, mesh=m)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8,
                                                   dtype=np.int32),
                        max_new=3 + i % 3) for i in range(6)]
        for r in reqs:
            srv.submit(r)
        while srv.step():
            pass
        tokens[m is not None] = [r.out for r in reqs]
    out["server"] = tokens
    # the kernel wrappers refuse DTensors
    x = distribute(torch.zeros((2, 4, 2, 16)), _rep(mesh))
    refused = []
    for call in (lambda: flash_attention(x, x, x),
                 lambda: segment_sums(
                     distribute(torch.zeros(4, dtype=torch.int32),
                                _rep(mesh)),
                     distribute(torch.zeros((4, 2)), _rep(mesh)), 2)):
        try:
            call()
        except TypeError as e:
            refused.append("DTensor" in str(e))
    out["refused"] = refused
    out["placed"] = placements_of(mesh, d["specs"])
    return out


def _rep(mesh):
    from repro_torch.distributed.sharding import scalar_sharding
    return scalar_sharding(mesh)


def placements_of(mesh, specs_by_name):
    """Each named (shape, spec) as ``arange`` placed by the port's
    shardings: this rank's mesh coordinate and local shards."""
    import math
    from repro_torch.distributed.sharding import Sharding
    shards = {}
    for name, (shape, spec) in specs_by_name.items():
        x = torch.arange(math.prod(shape), dtype=torch.int32).reshape(shape)
        shards[name] = Sharding(mesh, spec).place(x).to_local().numpy()
    return tuple(mesh.get_coordinate()), shards


# ------------------------------------------------------------ collectives

def collective_rank(rank, model_axis):
    """The collectives of one sharded matmul (x (8, 64) over "data", w
    (64, 32) over "model" along its input dim: a partial sum, reduced) and
    of one FSDP all-gather of a (64, 32) weight sharded over "data", counted
    by ``CollectiveCounter``."""
    from repro_torch.distributed.sharding import Sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import CollectiveCounter
    mesh = make_host_mesh(model_axis)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 64), generator=g)
    w = torch.randn((64, 32), generator=g)
    dx = Sharding(mesh, ("data", "model")).place(x)
    dw = Sharding(mesh, ("model", None)).place(w)
    with CollectiveCounter() as mm:
        y = (dx @ dw).redistribute(mesh, Sharding(mesh, ("data", None))
                                   .placements)
    fw = Sharding(mesh, ("data", None)).place(w)
    with CollectiveCounter() as ag:
        full = fw.redistribute(mesh, Sharding(mesh, ()).placements)
    ok = bool(torch.allclose(y.full_tensor(), x @ w, rtol=1e-5, atol=1e-5)
              and torch.equal(full.to_local(), w))
    return (mm.per_op, mm.calls), (ag.per_op, ag.calls), ok


def step_collectives(arch, mesh, batch, seq):
    """The collectives of one FSDP+TP train step of ``arch``'s smoke config
    (its own activations, weights of seed 0, ``make_batch``'s first batch
    of ``DataConfig(seed=0)``) on ``mesh``, after one warm step, counted by
    ``CollectiveCounter``: this rank's ``(per_op bytes, calls)``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  distribute,
                                                  param_shardings)
    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, lm_spec
    from repro_torch.optim import adamw
    cfg = get_config(arch, smoke=True)
    specs = lm_spec(cfg)
    params = distribute(init_params(specs, 0, device=CPU),
                        param_shardings(specs, mesh, "train"))
    opt = adamw.init(params)
    b, _ = make_batch(DataConfig(seed=0), cfg, batch, seq, init_state(),
                      device=CPU)
    b = distribute(b, batch_shardings(b, mesh, {"positions3": 1}))
    step = make_train_step(cfg, adamw.AdamWConfig(), device=CPU, mesh=mesh)
    params, opt, _ = step(params, opt, b)                   # warm
    with CollectiveCounter() as counter:
        step(params, opt, b)
    return counter.per_op, counter.calls
