"""Training driver: the train loop with checkpoint/restart, failure
detection and straggler monitoring (the reference's
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

runs on the CUDA card; ``--device cpu`` runs on the CPU. Given a
``model_axis`` m, ``train`` runs FSDP+TP on a ``(world // m, m)`` mesh over
the initialised process group (``torchrun``: one rank a card under NCCL,
or gloo ranks on the CPU): parameters and AdamW moments are DTensors under
the ``train`` rules, each batch is sharded over "data", and rank 0 writes
the checkpoints (restored into the same placements). ``model_axis=None``
(the default) runs on one device whether or not a group exists; a
``model_axis`` without a group raises, as does ``use_kernel`` (the flash
kernels have no backward pass). Eager torch compiles nothing, so the
reference's compile log has no counterpart.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-0.5b --model-axis 2 --steps 20 --batch 8 --seq 1024
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import DataConfig, init_state, make_batch
from ..device import resolve
from ..distributed import HeartbeatMonitor, StragglerDetector
from ..distributed.sharding import (batch_shardings, distribute,
                                    param_shardings)
from ..models import init_params, lm_spec
from ..optim import adamw
from .mesh import make_host_mesh
from .steps import NO_BACKWARD, make_train_step


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str], ckpt_every: int = 50, resume: bool = True,
          model_axis: Optional[int] = None, use_kernel: bool = False,
          log_every: int = 10,
          device=None, on_step: Optional[Callable[[dict], None]] = None):
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device`` (default CUDA), from weights of seed 0 and the data
    pipeline's seed 0. With ``ckpt_dir``: resume from its latest committed
    step (when ``resume``), save every ``ckpt_every`` steps (async) and once
    more at the end (blocking). ``on_step``, when given, receives each
    step's record ``{"step", "loss", "ce", "aux", "grad_norm", "lr",
    "seconds"}``. Returns the losses of the steps run.

    With ``model_axis`` (1 included) every rank calls ``train`` alike: the
    run is sharded over ``make_host_mesh(model_axis)`` (see the module
    docstring) and every rank returns the same losses. ``None`` runs on one
    device."""
    sharded = model_axis is not None
    if sharded and not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"model_axis={model_axis}: a sharded run needs an "
                         f"initialised process group (nccl on the cards, "
                         f"gloo on the CPU); without one, model_axis=None "
                         f"runs on one device")
    if use_kernel:
        raise ValueError(NO_BACKWARD)
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke)
    opt_cfg = adamw.AdamWConfig(decay_steps=max(steps, 2))
    mesh = make_host_mesh(model_axis) if sharded else None
    specs = lm_spec(cfg)
    params = init_params(specs, 0, device=dev)
    if mesh is not None:
        params = distribute(params, param_shardings(specs, mesh, "train"))
    opt_state = adamw.init(params)
    dstate = init_state()
    dc = DataConfig(seed=0)

    writer = mesh is None or dist.get_rank() == 0
    ckpt = Checkpointer(ckpt_dir, writer=writer) if ckpt_dir else None
    start_step = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        params, opt_state, dstate = ckpt.restore(
            None, (params, opt_state, dstate))
        start_step = int(ckpt.latest_step())
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, device=dev, mesh=mesh)
    detector = StragglerDetector()
    heart = HeartbeatMonitor()

    losses = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        b, dstate = make_batch(dc, cfg, batch, seq, dstate, device=dev)
        if mesh is not None:        # every rank made the whole batch
            b = distribute(b, batch_shardings(b, mesh, {"positions3": 1}))
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])              # waits for the step
        losses.append(loss)
        dt = time.perf_counter() - t0
        detector.observe(0, dt)
        heart.beat(0)
        if on_step is not None:
            on_step({"step": step, "seconds": dt,
                     **{k: float(v) for k, v in metrics.items()}})
        if writer and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step={step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state, dstate))
    if ckpt:
        ckpt.save(steps, (params, opt_state, dstate), blocking=True)
        ckpt.wait()
        if mesh is not None:
            dist.barrier()          # every rank sees the last commit
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=None,
                    help="shard over a (world // m, m) mesh (needs torchrun)")
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    launched = "RANK" in os.environ          # started by torchrun
    if launched and args.model_axis is None:
        args.model_axis = 1                 # every rank shares one run
    if launched:
        if args.device == "cpu":
            dist.init_process_group("gloo")
        else:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group("nccl")
    try:
        losses = train(args.arch, args.smoke, args.steps, args.batch,
                       args.seq, args.ckpt_dir, args.ckpt_every,
                       model_axis=args.model_axis,
                       use_kernel=args.use_kernel, device=args.device)
    finally:
        if launched:
            dist.destroy_process_group()
    if launched and int(os.environ["RANK"]) != 0:
        return
    if losses:
        print(f"[train] done; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print("[train] done; nothing left to run")


if __name__ == "__main__":
    main()
