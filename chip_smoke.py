#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--horizon TICKS] [--seed SEED]

Phases, one JSON line each; any failure raises and exits non-zero:

  gpu               the card's name and power limit (nvidia-smi)
  build             nvcc build of every kernel (segment_sums.cu,
                    flash_attention.cu and flash_attention_sm90.cu, one nvcc
                    each, started together); ptxas's registers and spills
                    of the wgmma flash kernel's instances
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
  model             the serving path of qwen2-0.5b at its full published
                    width (24 layers, d_model 896, 14/2 heads, vocab
                    152,064; weights from --seed, bf16 activations): a
                    prefill through make_prefill_step(use_kernel=True) at
                    prefill_32k's S = 32,768 (batch cut from 32 to 1 to fit
                    the time limit), 32 decode steps through make_serve_step,
                    then serve_demo at full width (12 requests, 4 slots);
                    launch counts are zeroed before it and read right after
                    (the flash kernel: once per layer of the prefill, every
                    launch on the bf16 wgmma route)
  engine_invariants drain invariants per protocol (T=64, R=4096) and the
                    analytic-oracle agreement (±15 %) at T=128 (horizon
                    100,000 ticks, cut from the reference test's 400,000)
  engine_vs_cpu     per protocol, one config on the card and on the CPU:
                    every SimState leaf must be equal
  kernels           segment_sums against its plain version at the reference
                    tests' shapes and at the main path's shape, with times
  flash             the flash kernels against their plain versions at the
                    reference tests' shapes, qwen2's heads at S = 2048,
                    Sq != Sk, head dim 128 and a transposed view: f32 (FMA
                    kernel) at 2e-6; bf16 on the wgmma kernel within 2e-2,
                    within 1.25x (+1e-6) of the max abs and RMS error of
                    the plain model with one bf16 rounding of P
                    (attention_bf16p_model) against the f32 oracle, and
                    within the bound of its split P (2^-18 max|v| + 2e-6);
                    bf16 at head dims 16 and 32 (FMA kernel) at 1e-5. The
                    kernel path against the plain path at full width (B=2,
                    S=2048: bf16 last-token logits within 2e-2 of max
                    |logit|; f32 prefill-then-decode against the full
                    forward within 2e-4); at the main path's shape the same
                    bf16 bar, then kernel and SDPA timed in turns (kernel,
                    library, library, kernel), the FMA kernel once in f32

The line before the last is the ``kernels`` summary and the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PROTOCOLS = ("mysql", "o1", "o2", "group", "bamboo", "brook2pl")
# device-memory bandwidth (bytes/s), non-tensor-core f32 peak and dense bf16
# tensor-core peak (FLOP/s) by card, from NVIDIA's data sheets (dense: half
# the sparse figure); the SXM part is the default
CARDS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),
}
ARCH = "qwen2-0.5b"
DECODE_STEPS = 32
# the FMA flash kernel against its plain version on the same inputs: both
# compute in f32 (FMA products, no TF32), so they differ only in the order of
# sums. The wgmma kernel splits P into two bf16 parts and is held instead to
# ref.bf16_errors: the model with one bf16 rounding of P, and the split's
# bound
SAME_INPUTS_TOL = 1e-5
# exp2 a clock on an SM's MUFU units (16 lanes), for the softmax's bound
MUFU_EXP2_PER_CLOCK = 16
# the bf16 kernel path may lie at most this factor farther from the f32 path
# than the bf16 plain path does (two draws of the same bf16 rounding)
BF16_PATH_MARGIN = 1.25


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_rates(name: str) -> tuple[float, float, float]:
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


def phase_build(kernel_mods) -> list[dict]:
    """One nvcc per kernel source, all started together. Returns ptxas's
    usage of the last module's kernels (the wgmma flash kernel's
    instances)."""
    from repro_torch.kernels.nvcc_build import ptxas_usage, report_path
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_mods)) as pool:
        libs = list(pool.map(lambda m: m.build(verbose=True), kernel_mods))
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(lib.relative_to(ROOT)) for lib in libs])
    usage = ptxas_usage(report_path(libs[-1]).read_text())
    emit("build", check="ptxas", source="flash_attention_sm90.cu",
         kernels=usage)
    return usage


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
    bw, f32_peak, _ = rates
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


def phase_model(seed: int) -> tuple:
    """The serving path at full width: prefill through the flash kernel at
    prefill_32k's length, decode steps, serve_demo. Returns (cfg, params)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.serve import serve_demo
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import count_params, init_params, lm_spec
    cfg = get_config(ARCH)
    shape = SHAPES["prefill_32k"]
    B, S = 1, shape.seq_len
    emit("model", check="cut", shape=shape.name, seq_len=S,
         global_batch=shape.global_batch, batch=B,
         note="batch cut from 32 to 1 to fit the time limit")
    t0 = time.perf_counter()
    params = init_params(lm_spec(cfg), seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step = make_prefill_step(cfg, use_kernel=True, max_len=S + DECODE_STEPS)
    t0 = time.perf_counter()
    logits, caches = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    assert logits.shape == (B, 1, cfg.padded_vocab), logits.shape
    assert bool(torch.isfinite(logits.float()).all()), "prefill logits"
    layer_caches = caches["g0"]["u0"]
    assert len(layer_caches) == cfg.n_layers
    assert layer_caches[0].k.shape == (B, S + DECODE_STEPS, cfg.n_kv_heads,
                                       cfg.hd), layer_caches[0].k.shape
    serve = make_serve_step(cfg)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks = [nxt]
    t0 = time.perf_counter()
    for i in range(DECODE_STEPS):
        nxt, caches = serve(params, {"tokens": nxt[:, None], "caches": caches,
                                     "pos": S + i})
        toks.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    toks = torch.stack(toks, 1)
    assert bool(((toks >= 0) & (toks < cfg.padded_vocab)).all())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    emit("model", check="prefill_decode", arch=ARCH,
         params=count_params(lm_spec(cfg)), act_dtype=cfg.act_dtype,
         batch=B, seq_len=S, init_s=init_s, prefill_s=prefill_s,
         prefill_tokens_per_s=B * S / prefill_s, decode_steps=DECODE_STEPS,
         decode_ms_per_step=1e3 * decode_s / DECODE_STEPS,
         peak_memory_gib=peak_gb, tokens=toks[0, :8].tolist())
    del caches, logits
    t0 = time.perf_counter()
    srv = serve_demo(ARCH, n_requests=12, batch_slots=4, smoke=False,
                     seed=seed, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = sum(4 + rid % 5 for rid in range(12))
    assert srv.members_served == want and not srv.queue \
        and all(r is None for r in srv.active), (srv.members_served, want)
    emit("model", check="serve_demo", requests=12, slots=4,
         steps_fired=srv.steps_fired, members_served=srv.members_served,
         wall_s=wall, note="wall includes init_params at full width")
    return cfg, params


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def bf16_chunked(q, k, v, fn, chunk: int = 2048):
    """A plain causal attention ``fn`` at a long S by query chunks (the
    whole score matrix would need 60 GB at 32k): chunk [a, b) against keys
    [0, b) is exactly causal."""
    S = q.shape[1]
    return torch.cat([fn(q[:, a:a + chunk], k[:, :a + chunk],
                         v[:, :a + chunk]) for a in range(0, S, chunk)],
                     dim=1)


def gpu_query(*fields: str) -> dict:
    """nvidia-smi's reading of ``fields`` for the first card."""
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    values = smi.stdout.strip().splitlines()[0].split(", ")
    return dict(zip(fields, values))


def phase_flash(cfg, params, seed: int, launches: int, by_route: dict,
                ptxas: list, rates) -> dict:
    from repro_torch.kernels.flash_attention import (
        flash_attention, attention_ref, attention_bf16p_model, route)
    from repro_torch.kernels.flash_attention import kernel_sm90
    from repro_torch.kernels.flash_attention.ref import bf16_errors
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.launch.steps import make_prefill_step
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # cases added since the first flash kernel draw from their own
    # generator, so the full-width checks below see the same tokens as then
    extra = torch.Generator(device="cuda").manual_seed(seed + 1)
    # (B, Sq, Sk, H, K, D, transposed view, generator)
    cases = [(2, 64, 64, 4, 2, 32, 0, gen),         # tests/test_kernels.py
             (1, 128, 128, 8, 8, 64, 0, gen),       # :59-64
             (2, 96, 96, 6, 1, 16, 0, gen),
             (1, 256, 256, 2, 2, 128, 0, gen),
             (1, 2048, 2048, 14, 2, 64, 0, gen),    # qwen2 heads
             (2, 300, 2048, 14, 2, 64, 0, gen),     # Sq != Sk
             (2, 1000, 1000, 8, 2, 128, 0, extra),  # head dim 128
             (2, 300, 300, 14, 2, 64, 1, extra)]    # (B, H, S, D) data

    def rand(g, shape, dt, transposed):
        if transposed:      # a (B, S, H, D) view of a (B, H, S, D) tensor
            b, s_, h, d = shape
            return _rand(g, (b, h, s_, d), dt).transpose(1, 2)
        return _rand(g, shape, dt)

    for B, Sq, Sk, H, K, D, tr, g in cases:
        for dt in (torch.float32, torch.bfloat16):
            q = rand(g, (B, Sq, H, D), dt, tr)
            k, v = (rand(g, (B, Sk, K, D), dt, tr) for _ in range(2))
            path = route(q, k, v)
            before = flash_attention.launches_by_route[path]
            got = flash_attention(q, k, v, causal=True)
            assert flash_attention.launches_by_route[path] == before + 1
            want = attention_ref(q, k, v, causal=True)
            row = dict(shape=[B, Sq, Sk, H, K, D], transposed=bool(tr),
                       dtype=str(dt), kernel_route=path)
            if path == "wgmma":
                e = bf16_errors(got, want,
                                attention_bf16p_model(q, k, v, causal=True),
                                v)
                emit("flash", check="vs_plain", **row, **e)
                assert e["ok"], ("wgmma kernel vs plain", row, e)
            else:
                # f32: the reference's 2e-6; bf16 at head dims 16 and 32
                # (the FMA kernel, f32 arithmetic on the same inputs): 1e-5
                bar = 2e-6 if dt == torch.float32 else SAME_INPUTS_TOL
                torch.testing.assert_close(got, want, rtol=bar, atol=bar)
                emit("flash", check="vs_plain", **row, tol=bar,
                     max_abs_err=float((got - want).abs().max()))

    # the kernel path against the plain path at full width
    B, S = 2, 2048
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device="cuda")
    lk, _ = prefill(params, cfg, tokens=toks[:, :S], use_kernel=True)
    lp, _ = prefill(params, cfg, tokens=toks[:, :S], use_kernel=False)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    lf, caches = make_prefill_step(cfg32, use_kernel=True, max_len=S + 1)(
        params, {"tokens": toks[:, :S]})
    lk, lp = lk.float(), lp.float()
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    f32_scale = float(lf.abs().max())
    # how far each bf16 path lies from the f32 one: bf16's own rounding
    # through 24 layers, the floor under the kernel-vs-plain difference.
    # The two bf16 paths differ in attention's order of f32 sums (the kernel
    # splits P into two bf16 parts: P to 2^-18), so their distances are two
    # draws of that rounding; a kernel fault moves logits by the size of the
    # logits instead
    k_rel = float((lk - lf).abs().max()) / f32_scale
    p_rel = float((lp - lf).abs().max()) / f32_scale
    emit("flash", check="path_bf16", batch=B, seq_len=S, max_abs_err=err,
         max_abs_logit=scale, rel=err / scale, tol=2e-2,
         kernel_vs_f32_rel=k_rel, plain_vs_f32_rel=p_rel,
         rounding_margin=BF16_PATH_MARGIN)
    assert err <= 2e-2 * scale, ("bf16 kernel path", err, scale)
    assert k_rel <= BF16_PATH_MARGIN * p_rel, ("bf16 kernel path farther "
                                               "from f32", k_rel, p_rel)
    lpf, _ = prefill(params, cfg32, tokens=toks[:, :S], use_kernel=False)
    err = float((lf - lpf).abs().max())
    scale = float(lpf.abs().max())
    emit("flash", check="path_f32_kernel_vs_plain", batch=B, seq_len=S,
         max_abs_err=err, max_abs_logit=scale, rel=err / scale, tol=2e-4)
    assert err / scale < 2e-4, ("f32 kernel path vs plain path", err, scale)
    del lpf
    full = forward(params, cfg32, tokens=toks, mode="prefill").logits[:, -1]
    ld, _ = decode_step(params, cfg32, tokens=toks[:, S:], caches=caches,
                        pos=S)
    err = float((full - ld[:, 0]).abs().max())
    scale = float(full.abs().max())
    emit("flash", check="path_f32_prefill_decode", batch=B, seq_len=S,
         max_abs_err=err, max_abs_logit=scale, rel=err / scale, tol=2e-4)
    assert err / scale < 2e-4, ("f32 prefill-then-decode", err, scale)
    del caches, full

    # the main path's shape: prefill_32k, batch 1, qwen2's heads
    B, S, H, K, D = 1, 32_768, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _rand(gen, (B, S, H, D), torch.bfloat16)
    k, v = (_rand(gen, (B, S, K, D), torch.bfloat16) for _ in range(2))
    assert route(q, k, v) == "wgmma"
    got = flash_attention(q, k, v)
    want = bf16_chunked(q, k, v, attention_ref)
    e = bf16_errors(got, want, bf16_chunked(q, k, v, attention_bf16p_model),
                    v)
    emit("flash", check="vs_plain_main_path_shape", shape=[B, S, S, H, K, D],
         dtype="torch.bfloat16", kernel_route="wgmma", **e)
    assert e["ok"], ("wgmma kernel vs plain at the main path's shape", e)
    del got, want

    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    library_call = ("scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True), fused backends")

    def kernel_run():
        return flash_attention(q, k, v)

    def library_run():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    # in turns on one card: kernel, library, library, kernel
    turns = [(fn, cuda_ms(fn, reps=20)) for fn in
             (kernel_run, library_run, library_run, kernel_run)]
    card = gpu_query("clocks.sm", "clocks.max.sm", "temperature.gpu",
                     "power.draw", "power.limit")
    kernel_runs = [t for fn, t in turns if fn is kernel_run]
    library_runs = [t for fn, t in turns if fn is library_run]
    kernel_ms = sum(kernel_runs) / 2
    library_ms = sum(library_runs) / 2
    plain_ms = cuda_ms(lambda: bf16_chunked(q, k, v, attention_ref), reps=2)
    qf, kf, vf = q.float(), k.float(), v.float()
    assert route(qf, kf, vf) == "fma"
    earlier_ms = cuda_ms(lambda: flash_attention(qf, kf, vf), reps=1)
    del qf, kf, vf
    bw, f32_peak, bf16_peak = rates
    pairs = B * S * (S + 1) // 2              # (query, key) pairs attended
    flops = 4 * H * D * pairs                  # QK^T and PV, 2 per FMA
    nbytes = (B * S * H * D + 2 * B * S * K * D) * 2 + B * S * H * D * 4
    t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
    clock = float(card["clocks.max.sm"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_bound_ms = pairs * H / (MUFU_EXP2_PER_CLOCK * n_sm * clock * 1e6) * 1e3
    inst = kernel_sm90.instance_name(D)
    regs = [u for u in ptxas if inst in u["kernel"]]
    row = {"name": "flash_attention", "route": "cuda",
           "kernel_route": "wgmma",
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention_sm90.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
           "launches": launches, "launches_by_route": by_route,
           "max_abs_err": e["max_abs"], "rms_err": e["rms"],
           "model_max_abs_err": e["model_max_abs"],
           "model_rms_err": e["model_rms"],
           "split_p_bound": e["split_p_bound"], "ms": kernel_ms,
           "kernel_ms_runs": kernel_runs, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "library_ms_runs": library_runs,
           "library_call": library_call,
           "tflops": flops / (kernel_ms * 1e-3) / 1e12,
           "exp_bound_ms": exp_bound_ms, "sm_clock_max_mhz": clock,
           "sms": n_sm, "card_after_timing": card,
           "earlier_ms": earlier_ms,
           "earlier_source": "src/repro_torch/kernels/flash_attention/csrc/"
                             "flash_attention.cu (f32 inputs, FMA)",
           "f32_cores_bound_ms": flops / f32_peak * 1e3,
           "ptxas": regs[0] if regs else None,
           "shape": {"B": B, "S": S, "H": H, "K": K, "D": D,
                     "dtype": "bfloat16", "flops": flops, "bytes": nbytes,
                     "exp2": pairs * H}}
    emit("flash", check="main_path_shape", **row)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--horizon", type=int, default=50_000,
                    help="engine-phase horizon in ticks (0.1 us each); cut "
                         "from 200,000 so the eager engine (~10 ms per "
                         "iteration on an H100 host) fits the time limit")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model's weights and inputs")
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
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import kernel_sm90
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import ROUTES

    def zero_counts():
        segment_sums.launches = flash_attention.launches = 0
        flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)

    walls = {}
    t_start = mark = time.perf_counter()

    def lap(label):
        nonlocal mark
        now = time.perf_counter()
        walls[label] = now - mark
        mark = now

    phase_gpu()
    name = torch.cuda.get_device_name(0)
    ptxas = phase_build([kernel, flash_kernel, kernel_sm90])
    lap("gpu+build")

    # the main path: engine at full width, then the group-locking apply;
    # kernel launch counts are zeroed right before and read right after
    zero_counts()
    phase_engine(args.horizon)
    lap("engine")
    inputs = kernel_bench_inputs()
    phase_group_apply(inputs)
    torch.cuda.synchronize()
    launches = segment_sums.launches
    emit("main_path", launches={"segment_sums": launches,
                                "flash_attention": flash_attention.launches})
    assert launches > 0, "segment_sums never launched on the main path"
    lap("group_apply")

    # the model's serving path, counted the same way
    zero_counts()
    cfg, params = phase_model(args.seed)
    torch.cuda.synchronize()
    flash_launches = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    emit("model_path", launches={"segment_sums": segment_sums.launches,
                                 "flash_attention": flash_launches,
                                 "flash_attention_by_route": by_route})
    assert flash_launches == cfg.n_layers, \
        ("flash launches per prefill", flash_launches, cfg.n_layers)
    assert by_route == {"wgmma": cfg.n_layers, "fma": 0}, \
        ("a bf16 prefill's flash launches all take the wgmma route", by_route)
    lap("model")

    phase_engine_invariants()
    lap("engine_invariants")
    phase_engine_vs_cpu()
    lap("engine_vs_cpu")
    row = phase_kernels(inputs, launches, card_rates(name))
    lap("kernels")
    flash_row = phase_flash(cfg, params, args.seed, flash_launches, by_route,
                            ptxas, card_rates(name))
    lap("flash")
    emit("done", wall_s=time.perf_counter() - t_start, phase_wall_s=walls)
    print(json.dumps({"kernels": [row, flash_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
