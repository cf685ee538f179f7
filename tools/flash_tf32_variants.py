#!/usr/bin/env python3
"""Compare the shipped float32 flash kernel (3xTF32 on wgmma, with a prep
kernel) with the mma.sync design on the card, in one process.

    PYTHONPATH=src python tools/flash_tf32_variants.py [--reps 5]

  shipped    ``csrc/flash_attention_tf32.cu``: a prep kernel splits k and v
             into TF32 hi and lo (V transposed), TMA feeds wgmma m64nNk8
             .tf32, two consumer warpgroups, Q and P as register operands
  mma_sync   ``tools/flash_tf32_mma_sync.cu``: no prep; K and V tiles staged
             untransposed in shared memory, each warp loads and splits its
             B fragments and runs mma.sync.m16n8k8 .tf32 (head dim 64 only)

For each: ptxas's registers and spill bytes, the reference's f32 bar (2e-6
+ 2e-6 |want| against ``attention_ref``) at ragged shapes, causal and full,
and the time at qwen2-0.5b's f32 prefill shape (B=1, S=32,768, H=14, K=2,
D=64, causal), the two timed in turns (shipped, mma_sync, mma_sync,
shipped). Prints one JSON line per variant and the card's name, power limit
and clocks. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import nvcc_build
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                 kernel_tf32)
from repro_torch.kernels.flash_attention.ref import F32_TOL

MMA_SYNC = Path(__file__).resolve().parent / "flash_tf32_mma_sync.cu"
CHECK_SHAPES = [(1, 333, 333, 14, 2, 64), (2, 300, 2048, 14, 2, 64),
                (1, 100, 37, 14, 2, 64)]


def mma_sync_run(lib):
    """``fn(q, k, v, causal) -> out`` launching the mma.sync variant."""
    fn = lib.flash_tf32_mma_sync_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P, ctypes.c_float, I, P]
    fn.restype = ctypes.c_int

    def run(q, k, v, causal=True):
        B, Sq, H, D = q.shape
        Sk, K = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3], *out.stride()[:3])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 D, B, H, K, Sq, Sk, ctypes.cast(st, ctypes.c_void_p),
                 D ** -0.5 * math.log2(math.e), int(causal),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mma_sync variant: CUDA error {err}")
        return out
    return run


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bar_ratio(got, want) -> float:
    """The largest |got - want| over the f32 bar 2e-6 + 2e-6 |want|."""
    return float(((got - want).abs() / (F32_TOL + F32_TOL * want.abs()))
                 .max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
           "clocks.max.sm", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    libs = {"shipped": kernel_tf32.build(verbose=True),
            "mma_sync": nvcc_build.build_library(MMA_SYNC, verbose=True)}
    frag = {"shipped": kernel_tf32.instance_name(64),
            "mma_sync": "flash_tf32_mma_sync_kernel"}
    sync = mma_sync_run(ctypes.CDLL(str(libs["mma_sync"])))
    runs = {"shipped": lambda q, k, v, causal=True:
            flash_attention(q, k, v, causal),
            "mma_sync": sync}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, run in runs.items():
        report = nvcc_build.report_path(libs[name]).read_text()
        usage = [u for u in nvcc_build.ptxas_usage(report)
                 if frag[name] in u["kernel"]]
        worst = 0.0
        for B, Sq, Sk, H, K, D in CHECK_SHAPES:
            q = torch.randn((B, Sq, H, D), generator=gen, device="cuda")
            k, v = (torch.randn((B, Sk, K, D), generator=gen, device="cuda")
                    for _ in range(2))
            for causal in (True, False):
                worst = max(worst, bar_ratio(run(q, k, v, causal),
                                             attention_ref(q, k, v, causal)))
        rows[name] = {"variant": name, "ptxas": usage[0] if usage else None,
                      "bar_ratio_max": worst, "meets_bar": worst <= 1.0}
    B, S, H, K, D = 1, 32_768, 14, 2, 64
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda")
            for _ in range(2))
    order = ["shipped", "mma_sync", "mma_sync", "shipped"]
    times = [(n, cuda_ms(lambda n=n: runs[n](q, k, v), args.reps))
             for n in order]
    diff = float((runs["shipped"](q, k, v) - sync(q, k, v)).abs().max())
    flops = 4 * H * D * B * S * (S + 1) // 2
    for name in runs:
        ms = [t for n, t in times if n == name]
        rows[name].update(ms=sum(ms) / len(ms), ms_runs=ms,
                          tf32x3_tflops=3 * flops / (sum(ms) / len(ms))
                          / 1e9,
                          shape={"B": B, "S": S, "H": H, "K": K, "D": D,
                                 "dtype": "float32", "causal": True})
        print(json.dumps(rows[name]), flush=True)
    print(json.dumps({"shipped_vs_mma_sync_max_abs": diff}))
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
