#!/usr/bin/env python3
"""Where a full-width train step of the port goes, on the card.

    PYTHONPATH=src python tools/train_profile.py [--batch 8] [--seq 1024]

qwen2-0.5b at full width (f32 parameters and AdamW moments, bf16
activations, remat on), one make_batch batch, the work of
``make_train_step`` split into its three parts: the forward pass and loss
(``loss_fn`` under autograd), the backward pass (``torch.autograd.grad``,
with remat's recompute) and AdamW (``adamw.apply``), each timed with CUDA
events over ``--steps`` steps after ``--warmup``; then one step under
``torch.profiler``: the device time by kind of kernel (matrix products,
softmax and log-sum-exp, reductions, elementwise, copies), the number of
kernels, and the device-busy share (kernel time over the step's wall).
Prints JSON lines with the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


KINDS = (("matmul", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "cublas")),
         ("softmax_lse", ("softmax", "logsumexp")),
         ("reduce", ("reduce",)),
         ("copy", ("copy", "cat", "index", "gather", "scatter")),
         ("elementwise", ("elementwise", "vectorized")))


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(key in low for key in keys):
            return k
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.models import init_params, lm_spec, loss_fn
    from repro_torch.optim import adamw
    smi = card()
    cfg = get_config("qwen2-0.5b")
    opt_cfg = adamw.AdamWConfig()
    params = init_params(lm_spec(cfg), 0)
    opt = adamw.init(params)
    batch, _ = make_batch(DataConfig(), cfg, args.batch, args.seq,
                          init_state())

    def step(params, opt, marks=None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        live = tree.unflatten(params, leaves)
        if marks:
            marks[0].record()
        loss, _ = loss_fn(live, cfg, batch)
        if marks:
            marks[1].record()
        grads = torch.autograd.grad(loss, leaves)
        if marks:
            marks[2].record()
        params, opt, _ = adamw.apply(opt_cfg, tree.unflatten(params, grads),
                                     opt, params)
        if marks:
            marks[3].record()
        return params, opt

    for _ in range(args.warmup):
        params, opt = step(params, opt)
    torch.cuda.synchronize()
    parts = {"forward_loss": 0.0, "backward": 0.0, "adamw": 0.0}
    t0 = time.perf_counter()
    for _ in range(args.steps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        params, opt = step(params, opt, marks)
        torch.cuda.synchronize()
        for (name, a, b) in zip(parts, marks, marks[1:]):
            parts[name] += a.elapsed_time(b) / args.steps
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    print(json.dumps({"check": "parts", "card": smi, "batch": args.batch,
                      "seq": args.seq, "step_wall_ms": wall_ms,
                      "part_ms": parts}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt = step(params, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind: dict = {}
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        k = kind(e.name)
        ms = e.time_range.elapsed_us() / 1e3
        by_kind[k] = by_kind.get(k, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda r: -r[1])[:12]
    busy = sum(by_kind.values())
    print(json.dumps({"check": "profile", "card": smi,
                      "profiled_wall_ms": 1e3 * wall,
                      "device_ms": busy, "device_busy_share":
                      busy / (1e3 * wall), "kernels": n_kernels,
                      "device_ms_by_kind": by_kind,
                      "top_kernels_ms": [[n[:120], ms] for n, ms in top]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
