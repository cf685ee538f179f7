"""Training driver: the train loop with checkpoint/restart, failure
detection and straggler monitoring, on one device (the reference's
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

runs on the CUDA card; ``--device cpu`` runs on the CPU. The reference
builds a device mesh, shards parameters and batches over it and logs XLA
compiles; here there is one device and eager torch compiles nothing, so a
``model_axis`` other than 1 raises, as does ``use_kernel`` (the flash
kernels have no backward pass).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import DataConfig, init_state, make_batch
from ..device import resolve
from ..distributed import HeartbeatMonitor, StragglerDetector
from ..models import init_params, lm_spec
from ..optim import adamw
from .steps import NO_BACKWARD, make_train_step


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str], ckpt_every: int = 50, resume: bool = True,
          model_axis: int = 1, use_kernel: bool = False, log_every: int = 10,
          device=None, on_step: Optional[Callable[[dict], None]] = None):
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device`` (default CUDA), from weights of seed 0 and the data
    pipeline's seed 0. With ``ckpt_dir``: resume from its latest committed
    step (when ``resume``), save every ``ckpt_every`` steps (async) and once
    more at the end (blocking). ``on_step``, when given, receives each
    step's record ``{"step", "loss", "ce", "aux", "grad_norm", "lr",
    "seconds"}``. Returns the losses of the steps run."""
    if model_axis != 1:
        raise ValueError(f"model_axis={model_axis}: the port trains on one "
                         f"device; sharded execution is not ported")
    if use_kernel:
        raise ValueError(NO_BACKWARD)
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke)
    opt_cfg = adamw.AdamWConfig(decay_steps=max(steps, 2))
    params = init_params(lm_spec(cfg), 0, device=dev)
    opt_state = adamw.init(params)
    dstate = init_state()
    dc = DataConfig(seed=0)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        params, opt_state, dstate = ckpt.restore(
            None, (params, opt_state, dstate))
        start_step = int(ckpt.latest_step())
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, device=dev)
    detector = StragglerDetector()
    heart = HeartbeatMonitor()

    losses = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        b, dstate = make_batch(dc, cfg, batch, seq, dstate, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])              # waits for the step
        losses.append(loss)
        dt = time.perf_counter() - t0
        detector.observe(0, dt)
        heart.beat(0)
        if on_step is not None:
            on_step({"step": step, "seconds": dt,
                     **{k: float(v) for k, v in metrics.items()}})
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state, dstate))
    if ckpt:
        ckpt.save(steps, (params, opt_state, dstate), blocking=True)
        ckpt.wait()
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
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.ckpt_dir, args.ckpt_every,
                   model_axis=args.model_axis, use_kernel=args.use_kernel,
                   device=args.device)
    if losses:
        print(f"[train] done; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:
        print("[train] done; nothing left to run")


if __name__ == "__main__":
    main()
