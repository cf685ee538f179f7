#!/usr/bin/env python3
"""Execution across four cards: the port's FSDP+TP training, tensor-parallel
serving and sweep lanes over cards, each against one card.

    torchrun --nproc-per-node 4 tools/multicard_smoke.py

One rank a card, NCCL between them, a (2, 2) mesh named ("data", "model").
Before the process group exists, every rank runs the one-card references
that it needs on its own card; rank 0 also runs the one-card train steps,
and fig08's quick grid (mysql, o1, o2, group, bamboo, aria x threads 1, 64,
256, 1024; hotspot_update, txn_len 1, R = 1,000,000) at ``--sweep-horizon``
ticks, first on card 0 alone and then split over the four cards
(``run_sweep(devices=...)``, a worker process a card). Then, sharded:

  train    qwen2-0.5b at full width through ``train(model_axis=2)``
           (parameters and AdamW moments DTensors under the train rules,
           bf16 activations, remat; B = 8, S = 1,024, weights and data of
           seed 0) for ``--steps`` steps, against the one-card losses, with
           rank 0's peak memory; one more step through ``make_train_step``
           under ``CollectiveCounter`` for the collective bytes a step
           moves per rank; the roofline's row
           (``repro_torch.launch.roofline``) beside the step times
  serve    a tensor-parallel prefill (B = 2, S = 4,096, f32 activations:
           the flash kernel's tf32x3 route on each rank's local heads; its
           launches per rank) and 8 decode steps fed the one-card run's
           tokens, last-token logits against the one-card run's (2e-4);
           the collective bytes of a prefill
  moe_serve
           deepseek-v2-lite-16b at full width (bf16 weights of --seed, f32
           activations, attn_chunk 1,024): a tensor-parallel prefill of one
           4,096-token prompt and 8 decode steps fed the one-card run's
           greedy tokens; every step's last-token logits against the
           one-card run's (2e-4), each step's argmax equal to the token the
           one-card run chose, each MoE layer's drops beside one card's;
           the collective bytes of a prefill, the MoE's expert-parallel
           all-reduces among them
  moe_train
           deepseek-v2-lite-16b at full width cut to its dense layer and
           MOE_TRAIN_LAYERS MoE layers (what one card holds with f32
           parameters, grads and two AdamW moments, for the one-card
           losses), FSDP+TP through make_train_step (B = 8, S = 1,024, bf16
           activations, remat, make_batch of seed 0) for --steps steps
           against one card's (2^-9), then one counted step

Each result is a JSON line from rank 0, with the cards' names and power
limits (nvidia-smi) beside them. ``--phases`` runs a subset of sweep,
train and serve. A failed check is reported after the process group is
gone (a rank that raised mid-way would leave the others waiting), and
fails the run; otherwise the last line is ``{"ok": true, ...}``. ``--device cpu --smoke`` rehearses it on the CPU over
gloo at the smoke config (the sweep at R = 4,096 and 4,000 ticks, two CPU
shards).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
TRAIN_SHAPE = (8, 1_024)
SERVE_SHAPE = (2, 4_096)
DECODE_STEPS = 8
MODEL_AXIS = 2
PHASES = ("sweep", "train", "serve", "moe_serve", "moe_train")
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_SERVE_SEQ = 4_096
MOE_ATTN_CHUNK = 1_024
# deepseek-v2-lite-16b's dense layer and this many of its 26 MoE layers
# train: 2.2 B parameters, 35 GB of f32 parameters, grads and moments
MOE_TRAIN_LAYERS = 3
# bars: a bf16 loss within one bf16 rounding (2^-9 relative) of the one-card
# loss; serving runs in f32 activations, its logits within the models' f32
# bar (2e-4 of max |logit|): in bf16 each rank rounds its partial sums of a
# row-parallel product before they are added, and a full-width (2, 2) run
# read 0.021-0.026 against one card
LOSS_TOL = 2.0 ** -9
LOGIT_TOL = 2e-4


def emit(phase: str, **fields) -> None:
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps({"phase": phase, **fields}), flush=True)


def cards() -> list[str]:
    if not torch.cuda.is_available():
        return []
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def fig8_points(horizon: int, R: int):
    from repro_torch.core.lock import WorkloadSpec
    from repro_torch.sweep import grid
    hot = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=R)
    return grid(["mysql", "o1", "o2", "group", "bamboo", "aria"], hot,
                [1, 64, 256, 1024], horizon=horizon,
                name_fmt="fig8_{protocol}_T{n_threads}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def prompt(cfg, dev, seed: int, shape=SERVE_SHAPE):
    B, S = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)


def greedy_tokens(params, cfg, tokens, dev):
    """The tokens a greedy one-card decode feeds after the prompt."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    B, S = tokens.shape
    logits, caches = make_prefill_step(
        cfg, use_kernel=True, max_len=S + DECODE_STEPS, device=dev)(
        params, {"tokens": tokens})
    serve = make_serve_step(cfg, device=dev)
    fed = []
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    for i in range(DECODE_STEPS):
        fed.append(nxt)
        nxt, caches = serve(params, {"tokens": nxt[:, None],
                                     "caches": caches, "pos": S + i})
    return fed


def decode_logits(params, cfg, tokens, fed, dev, mesh):
    """A prefill under ``CollectiveCounter``, then one timed prefill (its
    flash launches on this rank) and the decode steps fed ``fed``; every
    step's last-token logits, whole, on the host."""
    from repro_torch.distributed.sharding import on_mesh
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.launch.steps import make_prefill_step, whole
    from repro_torch.models import decode_step
    B, S = tokens.shape
    step = make_prefill_step(cfg, use_kernel=True, max_len=S + DECODE_STEPS,
                             device=dev, mesh=mesh)
    counter = CollectiveCounter()
    with counter:
        step(params, {"tokens": tokens})
    flash_attention.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    logits, caches = step(params, {"tokens": tokens})
    sync(dev)
    prefill_s = time.perf_counter() - t0
    launches = flash_attention.launches
    outs = [whole(logits).float().cpu()]
    t0 = time.perf_counter()
    for i, nxt in enumerate(fed):
        with on_mesh(mesh):
            lg, caches = decode_step(params, cfg, tokens=nxt[:, None],
                                     caches=caches, pos=S + i, device=dev)
        outs.append(whole(lg).float().cpu())
    sync(dev)
    decode_ms = 1e3 * (time.perf_counter() - t0) / max(len(fed), 1)
    return outs, launches, counter, prefill_s, decode_ms


def roofline_row(cfg, step: str, B: int, S: int, chips: int, coll,
                 card_name: str, remat: bool) -> dict:
    """The roofline of a step per card: model FLOPs (a train step with remat
    recomputes one forward, 8 N T instead of 6 N T), the analytic HBM bytes
    (f32 parameters; AdamW's two f32 moments), the counted collective bytes,
    at the card's HBM and NVLink rates and its peak for ``cfg.act_dtype``
    (bf16 on the tensor cores; f32 on the CUDA cores, TF32 being off)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.roofline import (Roofline, analytic_hbm_bytes,
                                             card, model_flops_estimate)
    shape = ShapeSpec(step, S, B, step)
    mf = model_flops_estimate(cfg, shape)
    flops = mf * (8 / 6 if step == "train" and remat else 1) / chips
    n = cfg.param_count()
    shards = chips if step == "train" else MODEL_AXIS if chips > 1 else 1
    hbm = analytic_hbm_bytes(cfg, shape, chips, 4 * n,
                             8 * n if step == "train" else 0, shards)
    compute = "f32" if cfg.act_dtype == "float32" else "bf16"
    r = Roofline.on(card(card_name), compute, arch=cfg.name, shape=step,
                    mesh=f"{chips}", chips=chips, flops=flops,
                    bytes_accessed=hbm, coll_bytes=float(coll.total) if coll
                    else 0.0, coll_breakdown=dict(coll.per_op) if coll
                    else {}, model_flops=mf)
    return {**r.row(), "t_bound_s": r.t_bound}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--sweep-horizon", type=int, default=60_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="a comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config and a small sweep (a CPU "
                         "rehearsal)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import distribute, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, lm_spec
    from repro_torch.sweep import run_sweep

    cuda = args.device != "cpu"
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    smi = cards()
    card_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    cfg = get_config(ARCH, smoke=args.smoke)
    serve_cfg = dataclasses.replace(cfg, act_dtype="float32")
    B, S = (8, 32) if args.smoke else TRAIN_SHAPE
    emit("cards", nvidia_smi=smi, world=world, torch=torch.__version__,
         cuda=torch.version.cuda, phases=sorted(phases))
    t_start = time.perf_counter()
    failures = []           # checked after the group is gone: a rank that
                            # raised mid-way would leave the others waiting

    # ---- one card, before the process group exists
    serve_tokens = prompt(cfg, dev, args.seed)
    fed = [torch.zeros(SERVE_SHAPE[0], dtype=torch.int32, device=dev)
           for _ in range(DECODE_STEPS)]
    if rank == 0 and "serve" in phases:
        params = init_params(lm_spec(cfg), args.seed, device=dev)
        fed = greedy_tokens(params, serve_cfg, serve_tokens, dev)
        one_serve = decode_logits(params, serve_cfg, serve_tokens, fed, dev,
                                  None)
        del params
    if rank == 0 and "train" in phases:
        records = []
        one_losses = train(ARCH, args.smoke, args.steps, B, S, None,
                           log_every=100, device=dev,
                           on_step=records.append)
        one_ms = [1e3 * r["seconds"] for r in records]
        emit("train", check="one_card", losses=one_losses, ms=one_ms,
             batch=B, seq_len=S, card=smi[:1])
    moe_cfg = moe_serve_cfg(args.smoke)
    moe_tokens = prompt(moe_cfg, dev, args.seed,
                        (1, 64 if args.smoke else MOE_SERVE_SEQ))
    moe_fed = [torch.zeros(1, dtype=torch.int32, device=dev)
               for _ in range(DECODE_STEPS)]
    moe_one = moe_train_one = None
    if rank == 0 and "moe_serve" in phases:
        params = init_params(lm_spec(moe_cfg), args.seed,
                             dtype=torch.bfloat16, device=dev)
        moe_fed = greedy_tokens(params, moe_cfg, moe_tokens, dev)
        moe_one = moe_logits(params, moe_cfg, moe_tokens, moe_fed, dev, None)
        del params
        sync(dev)
        if cuda:
            torch.cuda.empty_cache()
    if rank == 0 and "moe_train" in phases:
        moe_train_one = moe_train_run(moe_train_cfg(args.smoke), args, dev,
                                      B, S, None)
        emit("moe_train", check="one_card", losses=moe_train_one[0],
             ms=moe_train_one[1], batch=B, seq_len=S, card=smi[:1])
        if cuda:
            torch.cuda.empty_cache()
    if rank == 0 and "sweep" in phases:
        R = 4_096 if args.smoke else 1_000_000
        horizon = 4_000 if args.smoke else args.sweep_horizon
        pts = fig8_points(horizon, R)
        devs = ([f"cuda:{i}" for i in range(world)] if cuda
                else ["cpu"] * 2)
        one = run_sweep(pts, device=devs[0])
        many = run_sweep(pts, device=devs[0], devices=devs)
        differing = [p.name for p in pts
                     if many[p.name].__dict__ != one[p.name].__dict__]
        emit("sweep", points=len(pts), rows=R, horizon=horizon,
             one_card_wall_s=one.wall_s, devices=devs,
             sharded_wall_s=many.wall_s,
             speedup=one.wall_s / many.wall_s,
             one_card_lane_iters=one.lane_iters,
             sharded_lane_iters=many.lane_iters, differing=differing,
             buckets=[dict(kind=b.kind, family=b.family, T=b.pad_threads,
                           points=b.n_points, wall_s=b.wall_s)
                      for b in one.buckets], cards=smi)
        if differing:
            failures.append(("sweep lanes differ", differing))

    dist.init_process_group("nccl" if cuda else "gloo",
                            timeout=datetime.timedelta(minutes=10))
    try:
        mesh = make_host_mesh(MODEL_AXIS)
        specs = lm_spec(cfg)
        if "train" in phases:
            train_phase(cfg, specs, mesh, args, dev, B, S, rank, world,
                        card_name, smi,
                        one_losses if rank == 0 else None,
                        one_ms if rank == 0 else None, failures)
        if "serve" in phases:
            # tensor-parallel serving, fed rank 0's one-card tokens
            for t in fed:
                dist.broadcast(t, 0)
            sp = distribute(init_params(specs, args.seed, device=dev),
                            param_shardings(specs, mesh, "serve"))
            outs, launches, pcount, prefill_s, decode_ms = decode_logits(
                sp, serve_cfg, serve_tokens, fed, dev, mesh)
            all_launches = [None] * world
            dist.all_gather_object(all_launches, launches)
            if rank == 0:
                errs = [rel(a, b) for a, b in zip(outs, one_serve[0])]
                Bs, Ss = SERVE_SHAPE
                emit("serve", check="tp", mesh=dict(zip(
                    mesh.mesh_dim_names, mesh.shape)), batch=Bs,
                    seq_len=Ss, decode_steps=DECODE_STEPS,
                    act_dtype=serve_cfg.act_dtype, logits_rel_err=errs,
                    tol=LOGIT_TOL, flash_launches_per_rank=all_launches,
                    prefill_s=prefill_s, decode_ms_per_step=decode_ms,
                    one_card_prefill_s=one_serve[3],
                    one_card_decode_ms_per_step=one_serve[4],
                    prefill_collective_bytes_per_rank=pcount.per_op,
                    roofline={f"{world}_cards": roofline_row(
                        serve_cfg, "prefill", Bs, Ss, world, pcount,
                        card_name, False), "1_card": roofline_row(
                        serve_cfg, "prefill", Bs, Ss, 1, None, card_name,
                        False)}, cards=smi)
                if max(errs) > LOGIT_TOL:
                    failures.append(("TP logits", errs))
                if cuda and any(n != cfg.n_layers for n in all_launches):
                    failures.append(("flash launches per rank",
                                     all_launches))
            del sp             # the MoE phases read their own peak memory
            if cuda:
                torch.cuda.empty_cache()
        if "moe_serve" in phases:
            for t in moe_fed:
                dist.broadcast(t, 0)
            moe_serve_phase(moe_cfg, mesh, args, dev, moe_tokens, moe_fed,
                            moe_one, rank, world, smi, failures)
        if "moe_train" in phases:
            moe_train_phase(mesh, args, dev, B, S, rank, world, card_name,
                            smi, moe_train_one, failures)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    emit("done", wall_s=time.perf_counter() - t_start, failures=failures)
    assert not failures, failures
    if rank == 0:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu" if cuda else "cpu", "kind": card_name,
            "count": torch.cuda.device_count() if cuda else 0}}),
            flush=True)
    return 0


def train_phase(cfg, specs, mesh, args, dev, B, S, rank, world, card_name,
                smi, one_losses, one_ms, failures) -> None:
    """FSDP+TP train steps through train(), then one counted step."""
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  distribute,
                                                  param_shardings)
    from repro_torch.launch.roofline import CollectiveCounter, card
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    records = []
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    losses = train(ARCH, args.smoke, args.steps, B, S, None,
                   model_axis=MODEL_AXIS, log_every=100, device=dev,
                   on_step=records.append)
    peak_gib = (torch.cuda.max_memory_allocated() / 2**30
                if dev.type == "cuda" else 0.0)
    ms = [1e3 * r["seconds"] for r in records]
    params = distribute(init_params(specs, args.seed, device=dev),
                        param_shardings(specs, mesh, "train"))
    opt = adamw.init(params)
    batch, _ = make_batch(DataConfig(seed=0), cfg, B, S, init_state(),
                          device=dev)
    batch = distribute(batch, batch_shardings(batch, mesh))
    step = make_train_step(cfg, adamw.AdamWConfig(), device=dev, mesh=mesh)
    params, opt, _ = step(params, opt, batch)           # warm
    counter = CollectiveCounter()
    with counter:
        params, opt, _ = step(params, opt, batch)
    del params, opt
    if rank != 0:
        return
    rel_loss = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
    steady = ms[1:] or ms
    step_ms = sum(steady) / len(steady)
    one_steady = one_ms[1:] or one_ms
    one_step_ms = sum(one_steady) / len(one_steady)
    rows = {f"{world}_cards": roofline_row(cfg, "train", B, S, world,
                                           counter, card_name, cfg.remat),
            "1_card": roofline_row(cfg, "train", B, S, 1, None, card_name,
                                   cfg.remat)}
    peak = card(card_name).bf16_flops
    emit("train", check="fsdp_tp", mesh=dict(zip(mesh.mesh_dim_names,
                                                  mesh.shape)),
         losses=losses, one_card_losses=one_losses, loss_rel=rel_loss,
         tol=LOSS_TOL, ms=ms, step_ms=step_ms,
         tokens_per_s=B * S / step_ms * 1e3, one_card_step_ms=one_step_ms,
         one_card_tokens_per_s=B * S / one_step_ms * 1e3,
         peak_memory_gib_rank0=peak_gib,
         collective_bytes_per_rank=counter.per_op,
         collective_calls_per_rank=counter.calls, roofline=rows,
         mfu_measured=rows[f"{world}_cards"]["model_flops"] / world
         / (step_ms / 1e3) / peak,
         one_card_mfu_measured=rows["1_card"]["model_flops"]
         / (one_step_ms / 1e3) / peak, cards=smi,
         note="steps after the first; the first is cold (DTensor's "
              "redistribution plans)")
    if max(rel_loss) > LOSS_TOL:
        failures.append(("FSDP+TP losses", losses, one_losses))


def moe_serve_cfg(smoke: bool):
    """deepseek-v2-lite-16b (its smoke config with --smoke) in f32
    activations, attn_chunk MOE_ATTN_CHUNK (8 at smoke size)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH, smoke=smoke),
                               act_dtype="float32",
                               attn_chunk=8 if smoke else MOE_ATTN_CHUNK)


def moe_train_cfg(smoke: bool):
    """deepseek-v2-lite-16b's dense layer and MOE_TRAIN_LAYERS MoE layers
    (the smoke config's one with --smoke)."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH, smoke=smoke)
    if smoke:
        return cfg
    (dense, _), (moe_unit, _) = cfg.layout
    return dataclasses.replace(cfg, layout=((dense, 1),
                                            (moe_unit, MOE_TRAIN_LAYERS)))


def moe_logits(params, cfg, tokens, fed, dev, mesh):
    """:func:`decode_logits` for the MoE model, with each MoE layer's drops
    of the timed prefill."""
    from repro_torch.launch.steps import whole
    from repro_torch.models.moe import MoEStatsLog
    with MoEStatsLog() as log:
        out = decode_logits(params, cfg, tokens, fed, dev, mesh)
    n_moe = sum(r for unit, r in cfg.layout for _, m in unit if "moe" in m)
    # counted prefill, timed prefill, then one call a decode step
    drops = [int(whole(st.dropped)) for st in log.stats[n_moe:2 * n_moe]]
    return (*out, drops)


def moe_serve_phase(cfg, mesh, args, dev, tokens, fed, one, rank, world,
                    smi, failures) -> None:
    """Tensor-parallel serving of the MoE model against one card."""
    from repro_torch.distributed.sharding import distribute, param_shardings
    from repro_torch.models import init_params, lm_spec
    sp = distribute(init_params(lm_spec(cfg), args.seed,
                                dtype=torch.bfloat16, device=dev),
                    param_shardings(lm_spec(cfg), mesh, "serve"))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    outs, _, pcount, prefill_s, decode_ms, drops = moe_logits(
        sp, cfg, tokens, fed, dev, mesh)
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else 0.0)
    del sp
    if rank != 0:
        return
    errs = [rel(a, b) for a, b in zip(outs, one[0])]
    chosen = [int(o[0, -1].argmax()) for o in outs[:-1]]
    want = [int(t[0]) for t in fed]
    emit("moe_serve", check="tp", arch=cfg.name, mesh=dict(zip(
        mesh.mesh_dim_names, mesh.shape)), batch=1,
        seq_len=tokens.shape[1], attn_chunk=cfg.attn_chunk,
        act_dtype=cfg.act_dtype, weights="bfloat16",
        decode_steps=DECODE_STEPS, logits_rel_err=errs, tol=LOGIT_TOL,
        tokens_equal=chosen == want, tokens=want, drops=drops,
        one_card_drops=one[5], drops_equal=drops == one[5],
        prefill_s=prefill_s, decode_ms_per_step=decode_ms,
        one_card_prefill_s=one[3], one_card_decode_ms_per_step=one[4],
        peak_memory_gib_rank0=peak,
        prefill_collective_bytes_per_rank=pcount.per_op,
        prefill_collective_calls_per_rank=pcount.calls, cards=smi,
        note="drops reported, not a bar: a last-bit change of an f32 "
             "router probability can move an assignment")
    if max(errs) > LOGIT_TOL:
        failures.append(("MoE TP logits", errs))
    if chosen != want:
        failures.append(("MoE TP tokens", chosen, want))


def moe_train_run(cfg, args, dev, B, S, mesh):
    """--steps make_train_step steps of ``cfg`` (weights and data of seed
    0) on one device or on ``mesh``; (losses, ms a step, the last step's
    collective counter)."""
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  distribute,
                                                  param_shardings)
    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, lm_spec
    from repro_torch.optim import adamw
    params = init_params(lm_spec(cfg), 0, device=dev)
    if mesh is not None:
        params = distribute(params, param_shardings(lm_spec(cfg), mesh,
                                                    "train"))
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(
        decay_steps=max(args.steps, 2)), device=dev, mesh=mesh)
    dstate, dc = init_state(), DataConfig(seed=0)
    losses, ms = [], []
    counter = CollectiveCounter()
    for i in range(args.steps + 1):
        b, dstate = make_batch(dc, cfg, B, S, dstate, device=dev)
        if mesh is not None:
            b = distribute(b, batch_shardings(b, mesh))
        sync(dev)
        t0 = time.perf_counter()
        if i == args.steps:              # one more step, counted
            with counter:
                params, opt, m = step(params, opt, b)
        else:
            params, opt, m = step(params, opt, b)
        loss = float(m["loss"])
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
    return losses[:-1], ms[:-1], counter


def moe_train_phase(mesh, args, dev, B, S, rank, world, card_name, smi,
                    one, failures) -> None:
    """FSDP+TP training of the cut MoE model against one card."""
    from repro_torch.launch.roofline import card
    cfg = moe_train_cfg(args.smoke)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, ms, counter = moe_train_run(cfg, args, dev, B, S, mesh)
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else 0.0)
    if rank != 0:
        return
    one_losses, one_ms, _ = one
    rel_loss = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
    steady = ms[1:] or ms
    step_ms = sum(steady) / len(steady)
    one_steady = one_ms[1:] or one_ms
    one_step_ms = sum(one_steady) / len(one_steady)
    rows = {f"{world}_cards": roofline_row(cfg, "train", B, S, world,
                                           counter, card_name, cfg.remat),
            "1_card": roofline_row(cfg, "train", B, S, 1, None, card_name,
                                   cfg.remat)}
    peak_flops = card(card_name).bf16_flops if dev.type == "cuda" else 1.0
    emit("moe_train", check="fsdp_tp", arch=cfg.name,
         layers=cfg.n_layers, params=cfg.param_count(),
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), batch=B,
         seq_len=S, losses=losses, one_card_losses=one_losses,
         loss_rel=rel_loss, tol=LOSS_TOL, ms=ms, step_ms=step_ms,
         tokens_per_s=B * S / step_ms * 1e3, one_card_ms=one_ms,
         one_card_step_ms=one_step_ms,
         one_card_tokens_per_s=B * S / one_step_ms * 1e3,
         peak_memory_gib_rank0=peak,
         collective_bytes_per_rank=counter.per_op,
         collective_calls_per_rank=counter.calls, roofline=rows,
         mfu_measured=rows[f"{world}_cards"]["model_flops"] / world
         / (step_ms / 1e3) / peak_flops, cards=smi,
         note="ms of the steps after the first (cold); the collective "
              "bytes of one more step")
    if max(rel_loss) > LOSS_TOL:
        failures.append(("MoE FSDP+TP losses", losses, one_losses))


if __name__ == "__main__":
    sys.exit(main())
