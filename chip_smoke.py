#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--horizon TICKS]

Phases, one JSON line each; any failure raises and exits non-zero:

  gpu               the card's name and power limit (nvidia-smi)
  build             nvcc build of every kernel of the path (segment_sums.cu)
  engine            the main path at full width: SysBench hotspot update
                    (txn_len 8, a 1,000,000-row table, 1024 threads,
                    attribution on) under the six tick-loop protocols, plus
                    hotspot_mix (Zipf 0.7) under group at a 50,000-tick
                    horizon (--horizon); per run iterations,
                    commits, TPS, wall seconds and ms per iteration, with the
                    tick-conservation and contention-attribution identities
  group_apply       the main path's group-locking apply at the kernel
                    benchmark's full size (V=50,000, D=512, N=262,144, Zipf
                    1.2 ids, threshold 32, max_hot 256) against the 2PL
                    oracle (evaluated in f64); kernel launch counts are read
                    right after it
  engine_invariants drain invariants per protocol (T=64, R=4096) and the
                    analytic-oracle agreement (±15 %) at T=128 (horizon
                    100,000 ticks, cut from the reference test's 400,000)
  engine_vs_cpu     per protocol, one config on the card and on the CPU:
                    every SimState leaf must be equal
  kernels           segment_sums against its plain version at the reference
                    tests' shapes and at the main path's shape, with times

The line before the last is the ``kernels`` summary and the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PROTOCOLS = ("mysql", "o1", "o2", "group", "bamboo", "brook2pl")
# device-memory bandwidth (bytes/s) and non-tensor-core f32 peak (FLOP/s) by
# card, from NVIDIA's data sheets; the SXM part is the default
CARDS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_rates(name: str) -> tuple[float, float]:
    for key, rates in CARDS.items():
        if key in name:
            return rates
    return CARDS["H100"]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after a warm-up."""
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


def phase_gpu() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit("gpu", nvidia_smi=line, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return line


def phase_build(kernel_mod) -> None:
    t0 = time.perf_counter()
    lib = kernel_mod.build(verbose=True)
    emit("build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(ROOT)))


def check_accounting(s, T: int) -> None:
    from repro_torch.core.lock import engine
    tb = s.g.tb.to(torch.int64)
    now = int(s.g.now)
    assert int(tb.sum()) % 2**32 == (T * now) % 2**32, "tick conservation"
    wait = int(s.g.ca[engine.CA_WAIT].to(torch.int64).sum())
    assert wait == int(tb[:, engine.TB_LOCKWAIT].sum()), "ca/lock_wait"


def phase_engine(horizon: int) -> list[dict]:
    from repro_torch.core.lock import WorkloadSpec, extract, engine
    T, R = 1024, 1_000_000
    hot = WorkloadSpec(kind="hotspot_update", txn_len=8, n_rows=R)
    mix = WorkloadSpec(kind="hotspot_mix", txn_len=8, n_rows=R,
                       zipf_s=0.7)
    runs = [(p, hot) for p in PROTOCOLS] + [("group", mix)]
    out = []
    for proto, wl in runs:
        cfg = engine.EngineConfig(
            protocol=engine.protocol_params(proto), costs=engine.CostModel(),
            workload=wl, n_threads=T, horizon=horizon, attrib=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = engine.run_sim(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_accounting(s, T)
        r = extract(proto, T, s)
        assert r.commits > 0 and np.isfinite(r.tps), (proto, wl.kind)
        row = dict(protocol=proto, kind=wl.kind, threads=T, rows=R,
                   horizon=horizon, iters=r.iters, commits=r.commits,
                   tps=r.tps, wall_s=wall, ms_per_iter=1e3 * wall / r.iters)
        emit("engine", **row)
        out.append(row)
    return out


def kernel_bench_inputs(V=50_000, D=512, N=262_144, s=1.2):
    """kernel_bench's full-size Zipf batch: ids from numpy seed 0, updates
    from a seeded generator on the card."""
    from repro_torch.core.lock.workload import zipf_cdf
    rng = np.random.default_rng(0)
    ids = np.searchsorted(zipf_cdf(V, s), rng.random(N)).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    upd = torch.randn((N, D), generator=gen, device="cuda")
    table = torch.zeros((V, D), device="cuda")
    return table, torch.from_numpy(ids).cuda(), upd


def phase_group_apply(inputs) -> None:
    from repro_torch.kernels.grouped_scatter import (
        grouped_scatter_apply, grouped_apply_ref)
    from repro_torch.core import batch_counts
    table, ids, upd = inputs
    got = grouped_scatter_apply(table, ids, upd, threshold=32, max_hot=256)
    # the 2PL oracle evaluated in f64: the hottest row takes ~45,000 updates,
    # where any f32 summation order (the oracle's own atomics included)
    # drifts by ~1e-3 on elements that cancel to O(1)
    want = grouped_apply_ref(table.double(), ids, upd.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    f32_oracle = grouped_apply_ref(table, ids, upd).double()
    counts = batch_counts(ids, table.shape[0])
    emit("group_apply", V=table.shape[0], D=table.shape[1], N=ids.shape[0],
         hot_rows=int((counts > 32).sum()), max_hot=256,
         max_updates_per_row=int(counts.max()),
         max_abs_err=float((got.double() - want).abs().max()),
         f32_oracle_max_abs_err=float((f32_oracle - want).abs().max()),
         rtol=1e-4, atol=1e-4, oracle="grouped_apply_ref in f64")


def phase_engine_invariants() -> None:
    from repro_torch.core.lock import (WorkloadSpec, CostModel, extract,
                                       protocol_params, run_sim, HALT)
    from repro_torch.core.lock.engine import EngineConfig
    from repro_torch.core.lock.ref_engine import predicted_tps
    for proto in PROTOCOLS:
        cfg = EngineConfig(
            protocol=protocol_params(proto), costs=CostModel(),
            workload=WorkloadSpec(kind="fit", txn_len=2, n_rows=4096,
                                  n_hot=2, seed=1),
            n_threads=64, horizon=20_000, p_abort=0.1, drain=True,
            max_iters=400_000)
        s = run_sim(cfg, device="cuda")
        leftover = int((s.rows.applied_val - s.rows.committed_val)
                       .abs().sum())
        ok = (bool((s.th.phase == HALT).all())
              and bool((s.th.ticket < 0).all()) and leftover == 0
              and int(s.g.commits) > 0)
        emit("engine_invariants", check="drain", protocol=proto,
             commits=int(s.g.commits), leftover=leftover, ok=ok)
        assert ok, ("drain invariants", proto)
    hot = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=512)
    for proto in ("mysql", "o1", "o2", "group", "bamboo"):
        cfg = EngineConfig(protocol=protocol_params(proto), costs=CostModel(),
                           workload=hot, n_threads=128, horizon=100_000)
        got = extract(proto, 128, run_sim(cfg, device="cuda")).tps
        want = predicted_tps(proto, 128, CostModel())
        ok = abs(got - want) <= 0.15 * want
        emit("engine_invariants", check="oracle", protocol=proto, tps=got,
             predicted=want, ok=ok)
        assert ok, ("oracle", proto, got, want)


def phase_engine_vs_cpu() -> None:
    from repro_torch.core.lock import (WorkloadSpec, CostModel,
                                       protocol_params, run_sim)
    from repro_torch.core.lock.convert import state_to_numpy
    from repro_torch.core.lock.engine import EngineConfig
    for proto in PROTOCOLS:
        cfg = EngineConfig(
            protocol=protocol_params(proto), costs=CostModel(),
            workload=WorkloadSpec(kind="hotspot_update", txn_len=8,
                                  n_rows=4096, write_ratio=0.7),
            n_threads=64, horizon=20_000, p_abort=0.05, attrib=True)
        a = state_to_numpy(run_sim(cfg, device="cuda"))
        b = state_to_numpy(run_sim(cfg, device="cpu"))
        diff = [f"{part}.{f}"
                for part in ("th", "rows", "g")
                for f, x, y in zip(getattr(a, part)._fields,
                                   getattr(a, part), getattr(b, part))
                if not (x.dtype == y.dtype and np.array_equal(x, y))]
        emit("engine_vs_cpu", protocol=proto, iters=int(a.g.iters),
             differing_leaves=diff, f32_tolerance=0.0)
        assert not diff, (proto, diff)


def phase_kernels(inputs, launches: int, rates) -> dict:
    from repro_torch.kernels.grouped_scatter import (
        segment_sums, segment_sums_ref, hot_groups)
    rng = np.random.default_rng(42)
    cases = [(n, d, g, dt) for n, d, g in [(64, 8, 4), (700, 130, 37),
                                           (1024, 256, 1), (33, 7, 33),
                                           (512, 64, 100)]
             for dt in (torch.float32, torch.float16)]
    for n, d, g, dt in cases:
        seg = torch.from_numpy(np.sort(rng.integers(0, g, n))
                               .astype(np.int32)).cuda()
        upd = torch.from_numpy(rng.normal(size=(n, d))).to("cuda", dt)
        tol = 2e-4 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(segment_sums(seg, upd, g),
                                   segment_sums_ref(seg, upd, g),
                                   rtol=tol, atol=tol)
    seg = torch.from_numpy(rng.integers(-1, 10, 200).astype(np.int32)).cuda()
    upd = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32))
    upd = upd.cuda()
    torch.testing.assert_close(segment_sums(seg, upd, 9),
                               segment_sums_ref(seg, upd, 9),
                               rtol=1e-5, atol=1e-5)
    emit("kernels", check="shapes", cases=len(cases) + 1, ok=True)

    # the main path's shape: the group index grouped_scatter_apply builds
    table, ids, upd = inputs
    G, (N, D) = 256, upd.shape
    _, gidx = hot_groups(ids, table.shape[0], 32, G)
    got, want = segment_sums(gidx, upd, G), segment_sums_ref(gidx, upd, G)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    err = float((got - want).abs().max())
    valid = int((gidx >= 0).sum())
    kernel_ms = cuda_ms(lambda: segment_sums(gidx, upd, G))
    # the same rows ordered by group: what the order of the row gather
    # costs (diagnostic, not the main path's input)
    order = torch.sort(gidx, stable=True).indices
    gs, us = gidx[order].contiguous(), upd[order].contiguous()
    kernel_sorted_ms = cuda_ms(lambda: segment_sums(gs, us, G))
    plain_ms = cuda_ms(lambda: segment_sums_ref(gidx, upd, G))
    lib_ids = torch.where(gidx >= 0, gidx, G).long()    # -1 -> spill row
    library_ms = cuda_ms(lambda: torch.zeros(
        (G + 1, D), device="cuda").index_add_(0, lib_ids, upd))
    bw, f32_peak = rates
    nbytes = valid * D * upd.element_size() + 4 * N + 4 * G * D
    t_bytes, t_ops = nbytes / bw * 1e3, valid * D / f32_peak * 1e3
    row = {"name": "segment_sums", "route": "cuda",
           "source": "src/repro_torch/kernels/grouped_scatter/csrc/"
                     "segment_sums.cu",
           "replaces": "src/repro/kernels/grouped_scatter/kernel.py:37",
           "launches": launches, "max_abs_err": err, "ms": kernel_ms,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "kernel_sorted_ids_ms": kernel_sorted_ms,
           "shape": {"N": N, "D": D, "G": G, "valid_rows": valid,
                     "bytes": nbytes}}
    emit("kernels", check="main_path_shape", **row)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--horizon", type=int, default=50_000,
                    help="engine-phase horizon in ticks (0.1 us each); cut "
                         "from 200,000 so the eager engine (~10 ms per "
                         "iteration on an H100 host) fits the time limit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.grouped_scatter import kernel, segment_sums

    walls = {}
    t_start = mark = time.perf_counter()

    def lap(label):
        nonlocal mark
        now = time.perf_counter()
        walls[label] = now - mark
        mark = now

    phase_gpu()
    name = torch.cuda.get_device_name(0)
    phase_build(kernel)
    lap("gpu+build")

    # the main path: engine at full width, then the group-locking apply;
    # kernel launch counts are zeroed right before and read right after
    segment_sums.launches = 0
    phase_engine(args.horizon)
    lap("engine")
    inputs = kernel_bench_inputs()
    phase_group_apply(inputs)
    torch.cuda.synchronize()
    launches = segment_sums.launches
    emit("main_path", launches={"segment_sums": launches})
    assert launches > 0, "segment_sums never launched on the main path"
    lap("group_apply")

    phase_engine_invariants()
    lap("engine_invariants")
    phase_engine_vs_cpu()
    lap("engine_vs_cpu")
    row = phase_kernels(inputs, launches, card_rates(name))
    lap("kernels")
    emit("done", wall_s=time.perf_counter() - t_start, phase_wall_s=walls)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
