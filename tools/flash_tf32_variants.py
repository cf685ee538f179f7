#!/usr/bin/env python3
"""Compare the shipped float32 flash kernel (3xTF32 on wgmma, with a prep
kernel) with other designs on the card, in one process.

    PYTHONPATH=src python tools/flash_tf32_variants.py [--reps 5]
                                                      [--part d64|d240|all]

Part d64, at head dim 64:

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
shipped).

Part d240, at gemma3-12b's global layers (D = 240): copies of the shipped
source whose ``Shape<240>`` line differs (:data:`D240_VARIANTS`), built under
``build/kernels/variants/``; each held on the same ragged inputs
(CHECK_DRAWS draws of CHECK_SHAPES_240, causal and full) to the bar against
``attention_ref`` (f32)
and measured against the same function in f64 (the f32 oracle's own
distance from it is printed too); then all timed in turns at the prefill
shape (B=1, S=8,192, H=16, K=8, causal), forward then backward through the
list, with SDPA in f32 (kv heads repeated beforehand) beside them.

Prints one JSON line per variant and the card's name, power limit and
clocks. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
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
CHECK_SHAPES_240 = [(1, 333, 333, 16, 8, 240), (2, 77, 300, 4, 2, 240),
                    (1, 130, 77, 4, 2, 240)]
CHECK_DRAWS = 4                     # random draws of each D = 240 shape
# the fields of Shape<240> (BK, STAGES, K_STAGES, NC, O_SMEM, Q_SMEM, PV_N,
# Q_GROUP, Q_REG) that each variant changes; "shipped" is the source as it
# is; BK16: 16-key tiles with all of Q in shared memory and two V^T stages
BK16 = {"BK": 16, "STAGES": 2, "K_STAGES": 1, "Q_REG": 0, "PV_N": 120,
        "Q_GROUP": 5}
D240_VARIANTS = {
    "shipped": {},
    "g1": {"Q_GROUP": 1},
    "g2": {"Q_GROUP": 2},
    "g5": {"Q_GROUP": 5},
    "pv_n120": {"PV_N": 120},
    "bk16": BK16,
    "bk16_g1": {**BK16, "Q_GROUP": 1},
    "bk16_k2_v1": {**BK16, "K_STAGES": 2, "STAGES": 1},
    "bk16_nc1_bq64": {**BK16, "NC": 1, "K_STAGES": 2},
}


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


def d240_variant(fields: dict) -> Path:
    """The shipped source with ``fields`` of its ``Shape<240>`` line
    replaced, written under ``build/kernels/variants/`` (the source itself
    when ``fields`` is empty)."""
    if not fields:
        return kernel_tf32.SOURCE
    src = kernel_tf32.SOURCE.read_text()
    line = re.search(r"template <> struct Shape<240> \{[^}]*\};", src).group()
    new = line
    for key, val in fields.items():
        new, n = re.subn(rf"\b{key} = \d+", f"{key} = {val}", new)
        assert n == 1, (key, line)
    name = "_".join(f"{k.lower()}{v}" for k, v in fields.items())
    out = nvcc_build.BUILD_DIR / "variants" / f"flash_attention_tf32_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src.replace(line, new))
    return out


def sdpa_f32(q, k, v):
    """``fn()``: scaled_dot_product_attention on (B, H, S, D) f32 copies of
    q, k and v with the kv heads repeated beforehand (causal)."""
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)


def oracle64(q, k, v, causal):
    """``attention_ref``'s function in float64 (causal mask bottom-right,
    fill -2e38): the exact result the f32 versions are measured from."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.double().reshape(B, Sq, K, H // K, D),
                     k.double()) * D ** -0.5
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = torch.where(mask, s, -2e38)
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, D)


def part_d240(reps: int, gen) -> None:
    """Part d240 (see the module's docstring)."""
    cases = []                      # the same checks for every variant
    for _ in range(CHECK_DRAWS):
        for B, Sq, Sk, H, K, D in CHECK_SHAPES_240:
            q = torch.randn((B, Sq, H, D), generator=gen, device="cuda")
            k, v = (torch.randn((B, Sk, K, D), generator=gen, device="cuda")
                    for _ in range(2))
            for causal in (True, False):
                cases.append((q, k, v, causal, attention_ref(q, k, v, causal),
                              oracle64(q, k, v, causal)))

    def bars(fn) -> dict:
        """``fn``'s largest error over the bar against the f32 oracle
        and against the f64 one, and the cases over the bar."""
        r32, r64 = zip(*((bar_ratio(fn(q, k, v, c), w32),
                          bar_ratio(fn(q, k, v, c), w64))
                         for q, k, v, c, w32, w64 in cases))
        return {"bar_ratio_max": max(r32), "bar_ratio_vs_f64_max": max(r64),
                "cases": len(cases), "cases_over_bar": sum(r > 1 for r in r32),
                "meets_bar": max(r32) <= 1.0}
    runs, rows = {}, {}
    for name, fields in D240_VARIANTS.items():
        source = d240_variant(fields)
        report = nvcc_build.report_path(
            nvcc_build.build_library(source, verbose=True)).read_text()
        lib = kernel_tf32.load(source)
        usage = [u for u in nvcc_build.ptxas_usage(report)
                 if kernel_tf32.instance_name(240) in u["kernel"]]

        def run(q, k, v, causal=True, lib=lib):
            out = torch.empty_like(q)
            kernel_tf32.launch(q, k, v, out, causal, q.shape[-1] ** -0.5,
                               lib=lib)
            return out
        runs[name] = run
        rows[name] = {"variant": name, "shape_240": fields,
                      "ptxas": usage[0] if usage else None, **bars(run)}

    print(json.dumps({"f32_oracle_vs_f64": {"bar_ratio_max": max(
        bar_ratio(w32, w64) for *_, w32, w64 in cases)}}), flush=True)
    del cases
    B, S, H, K, D = 1, 8_192, 16, 8, 240
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda")
            for _ in range(2))
    sdpa = sdpa_f32(q, k, v)
    runs["sdpa_f32"] = lambda q, k, v: sdpa()
    order = list(runs)
    times = [(n, cuda_ms(lambda n=n: runs[n](q, k, v), reps))
             for n in order + order[::-1]]
    flops = 4 * H * D * B * S * (S + 1) // 2
    bound_ms = 3 * flops / 494.7e12 * 1e3
    for name in order:
        ms = [t for n, t in times if n == name]
        row = rows.get(name, {"variant": name})
        row.update(ms=sum(ms) / len(ms), ms_runs=ms,
                   tf32x3_bound_ms=bound_ms,
                   shape={"B": B, "S": S, "H": H, "K": K, "D": D,
                          "dtype": "float32", "causal": True})
        print(json.dumps(row), flush=True)


def bar_ratio(got, want) -> float:
    """The largest |got - want| over the f32 bar 2e-6 + 2e-6 |want|."""
    return float(((got - want).abs() / (F32_TOL + F32_TOL * want.abs()))
                 .max())


def part_d64(reps: int, gen) -> None:
    """Part d64 (see the module's docstring)."""
    libs = {"shipped": kernel_tf32.build(verbose=True),
            "mma_sync": nvcc_build.build_library(MMA_SYNC, verbose=True)}
    frag = {"shipped": kernel_tf32.instance_name(64),
            "mma_sync": "flash_tf32_mma_sync_kernel"}
    sync = mma_sync_run(ctypes.CDLL(str(libs["mma_sync"])))
    runs = {"shipped": lambda q, k, v, causal=True:
            flash_attention(q, k, v, causal),
            "mma_sync": sync}
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
    times = [(n, cuda_ms(lambda n=n: runs[n](q, k, v), reps))
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--part", choices=("d64", "d240", "all"), default="all")
    args = ap.parse_args()
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
           "clocks.max.sm", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.part in ("d64", "all"):
        part_d64(args.reps, gen)
    if args.part in ("d240", "all"):
        part_d240(args.reps, gen)
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
