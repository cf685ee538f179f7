#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--horizon TICKS] [--seed SEED] [--ref-full]

Phases, one JSON line each; any failure raises and exits non-zero:

  gpu               the card's name and power limit (nvidia-smi)
  build             nvcc build of every kernel (segment_sums.cu,
                    flash_attention_sm90.cu and flash_attention_tf32.cu,
                    one nvcc each, started together); ptxas's registers
                    and spills of every kernel instance (among them the
                    wgmma bf16 flash kernel and the tf32x3 f32 one, each at
                    D = 16, 32, 64, 128, 240)
  engine            the main path at full width: SysBench hotspot update
                    (txn_len 8, a 1,000,000-row table, 1024 threads,
                    attribution on) under the six tick-loop protocols, plus
                    hotspot_mix (Zipf 0.7) under group at a 20,000-tick
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
  models            every other family's serving path. deepseek-v2-lite-16b
                    (MLA + MoE, 15.7 B parameters) at full width with bf16
                    weights from --seed: a prefill of one 4,096-token
                    prompt (prefill_32k's 32,768 x 32 cut to fit the time
                    limit) with attn_chunk 1,024; chunked against dense with
                    f32 activations over the same weights and deterministic
                    algorithms (last-token logits within 1e-4 of max
                    |logit|; the bf16 pair printed: see CHUNKED_TOL), the MoE
                    drop count of each layer, 32 absorbed-MLA decode steps
                    and a GroupServer of 12 requests over the same weights;
                    prefill s, tokens/s, decode ms a step, peak GiB. Then
                    the nine non-qwen2 architectures at their smoke configs
                    in f32 (B=2, S=24): prefill (kernel path) and a decode
                    step on the card against the port's CPU run of the same
                    weights (2e-4 relative, logits and caches; the CPU runs
                    in CHECK_WORKERS processes started before the phase),
                    prefill + decode against the full forward at capacity
                    factor 8 (2e-4), and one flash launch per global layer
                    and prefill, each on the route the table gives f32 at
                    the architecture's head dim (tf32x3 at the smoke
                    configs' 16 and 64). Then qwen2-0.5b's smoke config in
                    bf16 (head dim 16; B=2, S=333): a prefill on the kernel
                    path, one launch a layer, every one on wgmma, held to
                    the bars of the flash phase's bf16 path check against
                    the plain bf16 path and the plain f32 path; the phase's
                    wall
  train             the training half. qwen2-0.5b at full width (f32
                    parameters and AdamW moments, bf16 activations, remat
                    on; weights and data of seed 0) through train()'s own
                    loop: 6 steps of B=8, S=1,024 from make_batch (Zipf 1.0;
                    train_4k's 4,096 x 256 cut for the time limit), per step
                    the loss, grad norm, ms, tokens/s and model-FLOP share
                    of the dense bf16 rate, and the peak GiB; 4 steps on one
                    fixed batch (--seed; peak_lr 1e-3, warmup 1) whose loss
                    must fall; one smoke-size make_train_step (f32, B=2,
                    S=32) of each token-input architecture on the card
                    against the port's CPU run of the same weights and batch
                    (TRAIN_LOSS_TOL and the bars beside it; the CPU runs in
                    CHECK_WORKERS processes started before the phase); and a
                    restart at smoke size under deterministic algorithms: 4
                    steps straight (a checkpoint every 2) against 2 steps
                    and a fresh train() resuming at step 2, the resumed
                    losses equal bit for bit. No kernel lies on this path
                    (the flash kernels have no backward pass), so its counts
                    stay 0; the phase's wall
  engine_invariants drain invariants per protocol (T=64, R=4096) and the
                    analytic-oracle agreement (±15 %) at T=128 (horizon
                    100,000 ticks, cut from the reference test's 400,000),
                    each group of runs as one pack of lanes
  engine_vs_ref     the engine held to the JAX package's own answers,
                    carried here in tests/ref/engine_ref.json (written on a
                    CPU by tools/ref_fixture.py; a missing fixture, another
                    format or a configuration other than the fixture's
                    fails the smoke): the engine phase's seven full-width
                    final states (at the fixture's 20,000 ticks; at another
                    --horizon the fixture's seven configs run here again)
                    and six mid-size runs on the card (T=64, R=4096, txn_len
                    8, write ratio 0.7, p_abort 0.05, 10,000 ticks,
                    attribution on), every SimState leaf's dtype, shape and
                    sha256 equal to the reference's: a line a run with its
                    iterations and differing leaves (none allowed).
                    engine_invariants' two packs run on the card in two
                    worker processes meanwhile
  batch_width       one pack of hotspot_update at full width (txn_len 8,
                    R=1,000,000, T=1024, the six protocols cycled over the
                    lanes, attribution on) through engine._run_batch for 200
                    iterations a lane (max_iters) at G = 1, 2, 4, 8, 16: ms
                    per batched iteration, ms per lane-iteration, peak device
                    memory; conservation and ca/lock_wait on every lane
  sweep             Figure 8's grid (benchmarks/fig08_scalability.py: mysql,
                    o1, o2, group, bamboo, aria x threads 1, 64, 256, 1024,
                    hotspot_update txn_len 1) on a SysBench
                    --table-size=1000000 table at 120,000 ticks
                    (--sweep-horizon; cut from fig08's quick 200,000, which
                    took 198 s on an H100 80GB HBM3 at 700 W), through the
                    port's run_sweep at the card's default lane width: a
                    line per bucket and per point; tick conservation on
                    every engine lane and TestParserShapes' / TestAria's
                    orderings at the grid's thread counts; at the fixture's
                    horizon every point's record (tests/test_sweep.py's
                    parity fields) equal to the reference's per-config run
  sweep_vs_single   a mixed grid (six protocols x T 8, 40, 64 padded to 64 x
                    p_abort 0, 0.05, aria at each T, one drain lane; R=4096,
                    horizon 10,000, cut from 20,000 for the time limit)
                    compacted at width 8, sort-then-cut, and
                    in 4 segments (packed run_segment), each lane against its
                    single-lane run at the padded shape: metrics for the
                    sweeps, every leaf for the segmented runs (iters within
                    the reference's caveat); the differing leaves are printed
                    and must be none. On SEGMENT_FAULT_LANES the reference's
                    own segmented run departs from its single-shot run (a
                    fault the port copies), so there the card's segmented
                    runs are held to the port's CPU runs. The single-lane
                    runs go to SINGLE_LANE_WORKERS processes on the same
                    card while this process runs the packs, so the packs'
                    walls are taken beside them
  shards            execution across devices on the one card: sweep_vs_single's
                    grid compacted at width 8 through run_sweep with
                    devices=["cuda:0", "cuda:0"] (two spawned worker
                    processes, the lanes split by the reference's
                    _shard_lanes rule) equal lane for lane to the unsharded
                    run, both walls; a one-rank NCCL process group and its
                    (1, 1) mesh: two full-width qwen2-0.5b FSDP+TP steps
                    through train() (DTensor parameters and moments, B=8,
                    S=1,024) against the train phase's first two losses
                    (TRAIN_LOSS_TOL), and a tensor-parallel prefill at the
                    model phase's shape (S = 32,768, serve-rule placements,
                    the flash kernel on the rank's local heads) equal to the
                    model phase's logits bit for bit; launch counts zeroed before and
                    read after (24 flash launches, one a layer, per rank).
                    Then the MoE layer on the mesh: deepseek-v2-lite-16b at
                    full width (the models phase's configuration, weights
                    of --seed placed by DTensor.from_local, which shares
                    their storage on one rank): under deterministic
                    algorithms, a one-device prefill of the models phase's
                    4,096-token prompt (bf16, attn_chunk 1,024) and 8
                    decode steps, then the same on the mesh: logits equal
                    bit for bit to each other and to the models phase's,
                    tokens and each MoE layer's drop count equal; prefill s,
                    decode ms a step and peak GiB of both. Two FSDP+TP train
                    steps of each MoE architecture at its smoke config (f32,
                    the train phase's batch) against the train phase's card
                    step and a one-device second step (TRAIN_LOSS_TOL).
                    NCCL refuses two ranks on one card, so the mesh has one
                    rank (tools/multicard_smoke.py runs four)
  governed          run_governed at full width: the engine phase's table and
                    pool (hotspot update, txn_len 8, R=1,000,000, T=1024,
                    attribution on), stationary drift, 4 segments over the
                    engine phase's horizon, one pack of 8 lanes (a fixed
                    policy per protocol, the queue rule, epsilon-greedy):
                    each fixed lane equals the engine phase's run of its
                    protocol field for field (iters within 0..3), every
                    lane's segments add up and conserve ticks; wall, ms per
                    packed iteration, the rule and greedy preset timelines
  serving           serve at full width: the same table and pool saturated
                    (every request at tick 0, admission wait, 64 credits a
                    slot, never exhausted), 4 boundaries, the six protocols
                    as one pack: each lane equals the engine phase's run,
                    completions equal commits, every response counted
  adaptive_serving_vs_ref
                    small packs on the card, every record (whole-run metrics,
                    segment and boundary records, serving results) equal to
                    the fixture's reference runs: tests/test_adaptive.py's
                    batched-lanes cells (skew-ramp drift) at that test's
                    30,000 ticks and an open-load serving pack (Poisson at
                    0.3, 1 and 3 times capacity, reject and shed, 2 credits
                    a slot so slots HALT and revive, a queue-rule cell) at
                    TestAdmission's 20,000 ticks
  fig_grids         fig17's quick grid for its wall (mysql, group, brook2pl
                    x rho 0.01..1.0, T=32, R=4096, 24 boundaries) at 120,000
                    ticks, cut from the figure's quick 240,000 for the time
                    limit: the knee row, p50 <= p99 <= p999 <= max. fig15's
                    skew_ramp does not fit the limit even at 120,000 ticks
                    (alone: 55,564 packed iterations, 510.6 s on an H100
                    80GB HBM3 at 700 W); --fig15-horizon runs it alone
  trace             traced runs at the engine phase's full width and horizon
                    (hotspot update, txn_len 8, R=1,000,000, T=1024,
                    attribution on) for mysql, o2, bamboo and brook2pl, the
                    buffer sized for 8 T events an iteration: each run's
                    metrics equal the engine phase's untraced run (iters
                    included), nothing dropped, commit and abort events equal
                    the counters, time-ordered, resolved waits within the
                    lock-wait bin, certified serializable; traced ms per
                    iteration beside the untraced; o2 untraced and traced in
                    turns (untraced, traced, traced, untraced) with the
                    torch calls per iteration of each. One trace_on=False
                    mysql run equals the untraced run and stores nothing
  trace_vs_cpu      the certifier CLI's hotspot_update workload at seed 1
                    (T=16, R=256, txn_len 4, 40,000 ticks, p_abort 0.05, the
                    CLI's timeouts), six protocols traced on the card and on
                    the CPU, the twelve runs in CHECK_WORKERS processes:
                    events and Chrome-trace JSON equal, every card trace
                    certified
  prof              profile_step at full width for group and brook2pl
                    (n_iters 32, best of 3): the ranked stage table and the
                    CSV row, and the torch calls each ablation removes from
                    an iteration; for group's full step, the device-busy share
                    of a profiled window (CUDA kernel time from
                    torch.profiler over the window's wall, and over the
                    unprofiled wall) and the device time each ablation
                    removes; kernel launch counts around the three phases
                    stay 0 (no kernel lies on this path)
  kernels           segment_sums against its plain version at the reference
                    tests' shapes and at the main path's shape, with times
  flash             the flash kernels against their plain versions at the
                    reference tests' shapes, qwen2's heads at S = 2048,
                    Sq != Sk, head dim 128 and a transposed view: f32 (the
                    tf32x3 kernel, 3xTF32 on the tensor cores) at 2e-6;
                    bf16 (the wgmma kernel, head dims 16 and 32 included)
                    within 2e-2, within 1.25x (+1e-6) of the max abs and RMS
                    error of the plain model with one bf16 rounding of P
                    (attention_bf16p_model) against the f32 oracle, and
                    within the bound of its split P (2^-18 max|v| + 2e-6).
                    The kernel path against the plain path at full width
                    (B=2, S=2048: bf16 last-token logits within 2e-2 of max
                    |logit|; f32 prefill-then-decode against the full
                    forward within 2e-4); at the main path's shape the same
                    bf16 bar, then kernel and SDPA timed in turns (kernel,
                    library, library, kernel). The f32 route at the same
                    shape: the tf32x3 kernel against the plain version
                    (1e-5), timed beside SDPA on the same f32 inputs in
                    turns, with ptxas's registers and spills of its D = 64
                    instance (no spill allowed). The other head dims at
                    gemma3-12b's global shape (B=1, S=8,192, H=16, K=8): f32
                    on tf32x3 at D = 240, 16, 32 and 128 (1e-5), and bf16
                    on wgmma at D = 16 and 32 (the bf16 bar and the split's
                    bound), each timed beside SDPA in its dtype, with
                    ptxas's report of the tf32x3 D = 240 and the wgmma D =
                    16 and 32 instances (no spill allowed). Every flash
                    row's bound is the largest of its bytes, its tensor work
                    and one exp2 a visible pair on the MUFU units at the
                    card's maximum SM clock. gemma3-12b at full width (d
                    3840, 16/8 heads of 240, vocab 262,144; bf16 weights
                    from --seed) cut to one unit of its layout (5 local + 1
                    global, of 48 layers): one bf16 prefill of 4,096 tokens
                    on the kernel path (one wgmma launch, counted from 0),
                    the plain path and the f32 kernel path (one tf32x3
                    launch at D = 240, counted from 0), held to the bars
                    of qwen2's bf16 path check. gemma3-12b's global-layer
                    shape (B=1, S=8,192, H=16, K=8, D=240, bf16, causal) on
                    the wgmma kernel's D = 240 instance against the plain
                    version (the bf16 bar and the split's bound), then timed
                    beside SDPA (in turns), with its bound; ptxas's
                    registers and spills of the D = 240 instance (no spill
                    allowed)

``--ref-full`` runs only the card check (gpu) and the fixture's ``uncut``
points: tests/test_sweep.py's parity and compaction grids at their own
horizons (25,000, drain 12,000, 60,000, 120,000 ticks) and
tests/test_lock_engine.py::TestAria's runs at 400,000 ticks, 57 points as
one compacted run_sweep on the card, every record equal to the reference's
per-config run; then it exits.

``--fig15-horizon TICKS`` runs only the card check (gpu) and fig15's
skew_ramp scenario (benchmarks/fig15_adaptive.py: Zipf txn_len 4, R=8192,
T=64, 12 segments, three fixed protocols, the queue rule, epsilon-greedy)
through run_governed at that horizon, for its wall, then exits.

The line before the last is the ``kernels`` summary and the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

PROTOCOLS = ("mysql", "o1", "o2", "group", "bamboo", "brook2pl")
ARCH = "qwen2-0.5b"
DECODE_STEPS = 32
# the tf32x3 flash kernel against its plain version on the same long inputs
# (S = 8,192 and 32,768; the reference's 2e-6 holds at its test shapes). The
# wgmma kernel splits P into two bf16 parts and is held instead to
# ref.bf16_errors: the model with one bf16 rounding of P, and the split's
# bound
SAME_INPUTS_TOL = 1e-5
# exp2 a clock on an SM's MUFU units (16 lanes), for the softmax's bound
MUFU_EXP2_PER_CLOCK = 16
# the bf16 kernel path may lie at most this factor farther from the f32 path
# than the bf16 plain path does (two draws of the same bf16 rounding)
BF16_PATH_MARGIN = 1.25
# fig17's horizon in fig_grids, cut from the figure's quick 240,000 ticks
# for the time limit: 4,259 packed iterations, 44.7-60.4 s at 120,000
# (NVIDIA H100 80GB HBM3, 700 W)
FIG17_HORIZON = 120_000
# processes that run sweep_vs_single's single-lane runs on the card
SINGLE_LANE_WORKERS = 4
# processes beside the main one in the models and train phases (their CPU
# halves) and in trace_vs_cpu (both halves)
CHECK_WORKERS = 4
# engine_invariants' oracle pack: the protocols with an analytic model
ORACLE_PROTOCOLS = ("mysql", "o1", "o2", "group", "bamboo")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_rates(name: str) -> tuple[float, float, float, float]:
    """Device-memory bandwidth (bytes/s), non-tensor-core f32 peak, dense
    bf16 and dense TF32 tensor-core peaks (FLOP/s) of the card ``name``,
    from the port's card table (``repro_torch.launch.roofline.CARDS``, cited
    from NVIDIA's data sheet; the SXM part by default)."""
    from repro_torch.launch.roofline import card
    c = card(name)
    return c.hbm_bw, c.f32_flops, c.bf16_flops, c.tf32_flops


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
    usage of every kernel (one line per source), read by the checks of the
    tensor-core flash kernels' instances."""
    from repro_torch.kernels.nvcc_build import ptxas_usage, report_path
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_mods)) as pool:
        libs = list(pool.map(lambda m: m.build(verbose=True), kernel_mods))
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(lib.relative_to(ROOT)) for lib in libs])
    usage = []
    for mod, lib in zip(kernel_mods, libs):
        kernels = ptxas_usage(report_path(lib).read_text())
        emit("build", check="ptxas", source=mod.SOURCE.name, kernels=kernels)
        usage += kernels
    return usage


def check_accounting(s, T: int) -> None:
    from repro_torch.core.lock import engine
    tb = s.g.tb.to(torch.int64)
    now = int(s.g.now)
    assert int(tb.sum()) % 2**32 == (T * now) % 2**32, "tick conservation"
    wait = int(s.g.ca[engine.CA_WAIT].to(torch.int64).sum())
    assert wait == int(tb[:, engine.TB_LOCKWAIT].sum()), "ca/lock_wait"


def phase_engine(horizon: int) -> tuple[dict, dict, dict]:
    """The six protocols on SysBench hotspot update, then hotspot_mix under
    group (:func:`engine_full_configs`). Returns the hotspot-update runs'
    ``SimResult`` by protocol (the governed, serving and trace phases are
    held to them), their ms per iteration, and every run's
    :func:`engine_summary` by name (engine_vs_ref holds them to the
    reference)."""
    from repro_torch.core.lock import extract, engine
    T, R = 1024, 1_000_000
    out, ms, summaries = {}, {}, {}
    for name, cfg in engine_full_configs(horizon).items():
        kind, proto = name.split("/")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = engine.run_sim(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_accounting(s, T)
        r = extract(proto, T, s)
        assert r.commits > 0 and np.isfinite(r.tps), name
        summaries[name] = engine_summary(s)
        row = dict(protocol=proto, kind=kind, threads=T, rows=R,
                   horizon=horizon, iters=r.iters, commits=r.commits,
                   tps=r.tps, wall_s=wall, ms_per_iter=1e3 * wall / r.iters)
        emit("engine", **row)
        if kind == "hotspot_update":
            out[proto] = r
            ms[proto] = row["ms_per_iter"]
    return out, ms, summaries


# ---------------------------------------------------------------------------
# the reference fixture: the JAX package's own answers on the configurations
# below, computed on a CPU by tools/ref_fixture.py (which passes these
# configuration functions the reference's packages) and committed; the
# card's runs are held to them bit for bit
# ---------------------------------------------------------------------------

REF_FIXTURE = ROOT / "tests" / "ref" / "engine_ref.json"
REF_FORMAT = 1
# the engine phase's and the sweep phase's default horizons, at which the
# fixture holds their runs
REF_ENGINE_HORIZON = 20_000
FIG8_HORIZON = 120_000
# tests/test_adaptive.py's HORIZON, and the admission cases' horizon in
# tests/test_serving.py (TestAdmission)
GOVERNED_HORIZON = 30_000
SERVED_HORIZON = 20_000


def port_api() -> SimpleNamespace:
    """The port's packages, as the configuration functions take them."""
    import repro_torch.adaptive
    import repro_torch.core.lock
    import repro_torch.serving
    import repro_torch.sweep
    return SimpleNamespace(lock=repro_torch.core.lock,
                           sweep=repro_torch.sweep,
                           adaptive=repro_torch.adaptive,
                           serving=repro_torch.serving)


def engine_full_configs(horizon: int, api=None) -> dict:
    """phase_engine's seven runs at full width, by ``"<kind>/<protocol>"``:
    SysBench hotspot update (txn_len 8, R=1,000,000, T=1024, attribution
    on) under the six protocols, then hotspot_mix (Zipf 0.7) under
    group."""
    lk = (api or port_api()).lock
    R = 1_000_000
    hot = lk.WorkloadSpec(kind="hotspot_update", txn_len=8, n_rows=R)
    mix = lk.WorkloadSpec(kind="hotspot_mix", txn_len=8, n_rows=R,
                          zipf_s=0.7)
    return {f"{wl.kind}/{p}": lk.EngineConfig(
        protocol=lk.protocol_params(p), costs=lk.CostModel(), workload=wl,
        n_threads=1024, horizon=horizon, attrib=True)
        for p, wl in [(p, hot) for p in PROTOCOLS] + [("group", mix)]}


def engine_mid_configs(api=None) -> dict:
    """engine_vs_ref's mid-size runs, by protocol: T=64, R=4,096, txn_len
    8, write ratio 0.7, p_abort 0.05, 10,000 ticks, attribution on."""
    lk = (api or port_api()).lock
    wl = lk.WorkloadSpec(kind="hotspot_update", txn_len=8, n_rows=4096,
                         write_ratio=0.7)
    return {p: lk.EngineConfig(
        protocol=lk.protocol_params(p), costs=lk.CostModel(), workload=wl,
        n_threads=64, horizon=10_000, p_abort=0.05, attrib=True)
        for p in PROTOCOLS}


def ref_full_points(api=None) -> list:
    """The points of tests/test_sweep.py's parity and compaction grids at
    their own horizons (25,000; drain 12,000; mixed density 60,000;
    adaptive budget 120,000), and tests/test_lock_engine.py::TestAria's runs
    at its sizes and 400,000 ticks; each name prefixed by its case."""
    a = api or port_api()
    lk, sw = a.lock, a.sweep
    rep = dataclasses.replace
    hot = lk.WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=512)
    zipf = lk.WorkloadSpec(kind="zipf", txn_len=2, n_rows=256, zipf_s=0.9)
    z512 = rep(zipf, n_rows=512)
    H = 25_000
    cases = {
        "vmapped": sw.grid(["mysql", "group", "bamboo"], hot, [8, 12],
                           horizon=H, p_abort=[0.0, 0.1],
                           name_fmt="{protocol}_T{n_threads}_p{p_abort}"),
        "txn_len": [sw.point("group", zipf, 8, horizon=H, name="zl2"),
                    sw.point("group", rep(zipf, txn_len=4), 8, horizon=H,
                             name="zl4")],
        "max_bucket": [sw.point("mysql", zipf, 8, horizon=H, name="mx2"),
                       sw.point("mysql", rep(zipf, txn_len=4), 12,
                                horizon=H, name="mx4")],
        "aria": sw.grid("aria", hot, [8, 16], horizon=H),
        "override": [sw.point("group", hot, 16, horizon=H, name="gc_off",
                              group_commit=False)],
        "brook2pl": sw.grid(["brook2pl", "mysql"], rep(zipf, n_rows=251),
                            [8, 12], horizon=H, p_abort=[0.0, 0.1],
                            name_fmt="{protocol}_T{n_threads}_p{p_abort}"),
        "partial_pack": sw.grid(["mysql", "group", "o2", "bamboo", "o1"],
                                hot, 8, horizon=H),
        "padded": [sw.point("mysql", zipf, 8, horizon=H, name="mz2"),
                   sw.point("group", rep(zipf, txn_len=4), 12, horizon=H,
                            name="gz4"),
                   sw.point("o2", rep(zipf, txn_len=4), 24, horizon=H,
                            name="oz4")],
        "drain": sw.grid(["mysql", "group"], hot, [4, 8], horizon=12_000,
                         drain=True, name_fmt="d_{protocol}_T{n_threads}"),
        "aria_staggered": sw.zip_grid(
            "aria", hot, [8, 8, 16], horizon=H,
            costs=[lk.CostModel(), lk.CostModel(sync_lat=3_000),
                   lk.CostModel(sync_lat=9_000)],
            name_fmt="aria_T{n_threads}_s{sync_lat}"),
        "mixed_density": [
            sw.point(p, z512, t, horizon=60_000, name=f"{p}_T{t}")
            for p, t in (("o1", 16), ("mysql", 16), ("o2", 16), ("o2", 32),
                         ("o2", 64), ("group", 16), ("group", 32),
                         ("group", 64))],
        "adaptive_budget": [
            sw.point(p, z512, 16, horizon=120_000, name=f"{p}_T16")
            for p in ("o1", "mysql", "o2", "group")],
        "aria_orderings": [
            sw.point("aria", hot, 64, horizon=400_000, name="hot_T64"),
            sw.point("aria", hot, 512, horizon=400_000, name="hot_T512"),
            sw.point("aria", lk.WorkloadSpec(kind="zipf", zipf_s=0.99,
                                             txn_len=4, n_rows=8192),
                     256, horizon=400_000, name="zipf_T256")],
    }
    return [rep(p, name=f"{case}/{p.name}")
            for case, pts in cases.items() for p in pts]


def governed_spec(api=None) -> dict:
    """tests/test_adaptive.py::test_batched_lanes_match_sequential's cells
    (skew-ramp drift, the queue rule and two fixed policies) and run, at
    that test's horizon: ``run_governed``'s arguments."""
    a = api or port_api()
    lk, ad = a.lock, a.adaptive
    drift = lk.skew_ramp(lk.WorkloadSpec(kind="zipf", txn_len=2,
                                         n_rows=256, zipf_s=0.9),
                         3, lo=0.3, hi=1.1)
    return dict(cells=[ad.GovernorCell("r", ad.QueueRulePolicy(), drift, 8),
                       ad.GovernorCell("m", ad.FixedPolicy("mysql"), drift,
                                       12),
                       ad.GovernorCell("g", ad.FixedPolicy("group"), drift,
                                       8)],
                horizon=GOVERNED_HORIZON, n_segments=3, chunk_size=4)


def served_spec(api=None) -> dict:
    """An open-load serving pack at tests/test_serving.py's admission
    horizon (TestAdmission's workload and o2 pool, 2 credits a slot, so
    slots HALT and are revived): Poisson at 0.3, 1 and 3 times the pool's
    capacity under ``reject`` and ``shed``, plus a queue-rule cell;
    ``serve``'s arguments."""
    a = api or port_api()
    lk, ad, sv = a.lock, a.adaptive, a.serving
    w = lk.WorkloadSpec(kind="uniform", txn_len=2, n_rows=512,
                        write_ratio=1.0)
    T, H = 8, SERVED_HORIZON
    cap = T / sv.service_ticks(w, lk.CostModel(), "o2")
    cells = [sv.ServeCell(name=f"{adm}_{f}", workload=w, n_threads=T,
                          schedule=sv.poisson(f * cap, H, seed=i),
                          preset="o2", queue_cap=8, admission=adm,
                          max_outstanding=2)
             for i, (adm, f) in enumerate(
                 (adm, f) for adm in ("reject", "shed")
                 for f in (0.3, 1.0, 3.0))]
    cells.append(sv.ServeCell(name="rule", workload=w, n_threads=T,
                              schedule=sv.poisson(cap, H, seed=9),
                              preset="o2", policy=ad.QueueRulePolicy(),
                              queue_cap=8, admission="reject",
                              max_outstanding=2))
    return dict(cells=cells, seg_ticks=H // 8, chunk_size=8)


def engine_summary(s) -> dict:
    """A final engine state (either package) -> the fixture's record of it:
    ``iters``, ``commits``, ``now`` and every leaf's digest."""
    from repro_torch.core.lock.convert import state_digests, state_to_numpy
    if isinstance(s.g.now, torch.Tensor):
        s = state_to_numpy(s)
    return dict(iters=int(s.g.iters), commits=int(s.g.commits),
                now=int(s.g.now), digests=state_digests(s))


def governed_records(res) -> dict:
    """Every cell's whole-run metrics and segment records."""
    return {n: dict(result=dataclasses.asdict(res[n]),
                    segments=res.segments[n]) for n in res.names()}


def served_records(res) -> dict:
    """Every cell's serving result, boundary records and engine metrics."""
    return {n: dict(serving=dataclasses.asdict(res.serving[n]),
                    segments=res.segments[n],
                    result=dataclasses.asdict(res[n])) for n in res.names()}


def load_ref() -> dict:
    """The committed reference fixture; its format must be this script's."""
    if not REF_FIXTURE.is_file():
        raise SystemExit(f"chip_smoke: reference fixture {REF_FIXTURE} "
                         "missing (tools/ref_fixture.py writes it)")
    ref = json.loads(REF_FIXTURE.read_text())
    if ref.get("format") != REF_FORMAT:
        raise SystemExit(f"chip_smoke: reference fixture format "
                         f"{ref.get('format')} is not {REF_FORMAT}")
    return ref


def same(a, b) -> bool:
    """Two JSON-able trees equal field for field (floats exactly)."""
    from repro_torch.core.lock.convert import canonical
    return canonical(a) == canonical(b)


def check_configs(entry: dict, built: dict, what: str) -> None:
    """The configurations built here are the fixture's, name for name."""
    from repro_torch.core.lock.convert import config_doc
    assert sorted(entry) == sorted(built), (what, "names differ")
    bad = [n for n, obj in built.items()
           if not same(config_doc(obj), entry[n]["config"])]
    assert not bad, (what, "configs differ from the fixture's", bad)


def differing_leaves(got: dict, want: dict) -> list[str]:
    """Leaves whose digests (dtype, shape or bytes) differ."""
    return sorted(k for k in got.keys() | want.keys()
                  if not same(got.get(k), want.get(k)))


def phase_engine_vs_ref(ref: dict, summaries: dict | None) -> None:
    """The seven full-width runs held to the fixture's ``engine_full``
    leaf for leaf: phase_engine's final states when it ran at the fixture's
    horizon (``summaries``), else the fixture's seven configs run here."""
    from repro_torch.core.lock import engine
    entry = ref["engine_full"]
    cfgs = engine_full_configs(entry["horizon"])
    check_configs(entry["runs"], cfgs, "engine_full")
    bad = {}
    for name, cfg in cfgs.items():
        got = (summaries[name] if summaries is not None else
               engine_summary(engine.run_sim(cfg, device="cuda")))
        want = entry["runs"][name]
        diff = differing_leaves(got["digests"], want["digests"])
        emit("engine_vs_ref", entry="engine_full", run=name,
             horizon=entry["horizon"], iters=got["iters"],
             ref_iters=want["iters"], commits=got["commits"],
             ref_commits=want["commits"], differing_leaves=diff,
             rerun=summaries is None)
        if diff or any(got[k] != want[k] for k in ("iters", "commits",
                                                    "now")):
            bad[name] = diff
    assert not bad, ("full-width runs vs the reference", bad)


def phase_engine_mid_vs_ref(ref: dict) -> None:
    """engine_mid_configs' six runs on the card held to the fixture's
    ``engine_mid`` leaf for leaf."""
    from repro_torch.core.lock import run_sim
    entry = ref["engine_mid"]["runs"]
    cfgs = engine_mid_configs()
    check_configs(entry, cfgs, "engine_mid")
    bad = {}
    for proto, cfg in cfgs.items():
        got = engine_summary(run_sim(cfg, device="cuda"))
        diff = differing_leaves(got["digests"], entry[proto]["digests"])
        emit("engine_vs_ref", entry="engine_mid", run=proto,
             iters=got["iters"], ref_iters=entry[proto]["iters"],
             differing_leaves=diff)
        if diff:
            bad[proto] = diff
    assert not bad, ("mid-size runs vs the reference", bad)


def phase_ref_full(ref: dict) -> dict:
    """``--ref-full``: the fixture's ``uncut`` points (the CPU tests' cut
    grids at the reference tests' own horizons, Aria included) as one
    compacted ``run_sweep`` on the card, every record equal."""
    from repro_torch.core.lock.convert import sim_record
    from repro_torch.sweep import run_sweep
    entry = ref["uncut"]["points"]
    pts = ref_full_points()
    check_configs(entry, {p.name: p for p in pts}, "uncut")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep(pts, device="cuda")
    wall = time.perf_counter() - t0
    diff = [p.name for p in pts
            if not same(sim_record(res[p.name]), entry[p.name]["record"])]
    row = dict(points=len(pts), wall_s=wall, lane_iters=res.lane_iters,
               repacks=res.n_repacks,
               max_iters=max(res[p.name].iters for p in pts),
               differing=diff)
    emit("ref_full", **row)
    assert not diff, ("uncut points vs the reference", diff)
    return row


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


def _invariant_pack(check: str):
    """One of engine_invariants' packs at its full depth through
    ``engine._run_batch`` (every lane equals its single-lane run; see
    sweep_vs_single): ``drain`` (six protocols) or ``oracle`` (five). Its
    final state as numpy."""
    from repro_torch.core.lock import (WorkloadSpec, CostModel, engine,
                                       protocol_params, stack_lanes)
    from repro_torch.core.lock.convert import state_to_numpy
    from repro_torch.core.lock.engine import EngineConfig
    if check == "drain":
        fit = WorkloadSpec(kind="fit", txn_len=2, n_rows=4096, n_hot=2,
                           seed=1)
        cfgs = [EngineConfig(protocol=protocol_params(proto),
                             costs=CostModel(), workload=fit, n_threads=64,
                             horizon=20_000, p_abort=0.1, drain=True,
                             max_iters=400_000) for proto in PROTOCOLS]
    else:
        hot = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=512)
        cfgs = [EngineConfig(protocol=protocol_params(proto),
                             costs=CostModel(), workload=hot, n_threads=128,
                             horizon=100_000) for proto in ORACLE_PROTOCOLS]
    parts = [engine.split_config(c, device="cuda") for c in cfgs]
    stat = parts[0][0]
    return state_to_numpy(engine._run_batch(
        stat, stack_lanes([dp for _, dp in parts]),
        stack_lanes([engine.init_state_dyn(stat, dp) for _, dp in parts])))


def phase_engine_invariants(packs: dict) -> None:
    """The drain invariants and the analytic-oracle agreement on
    :func:`_invariant_pack`'s results (``packs``: futures by check)."""
    from repro_torch.core.lock import CostModel, HALT
    from repro_torch.core.lock.metrics import extract_globals
    from repro_torch.core.lock.ref_engine import predicted_tps
    s = packs["drain"].result()
    for i, proto in enumerate(PROTOCOLS):
        leftover = int(np.abs(s.rows.applied_val[i].astype(np.int64)
                              - s.rows.committed_val[i]).sum())
        ok = (bool((s.th.phase[i] == HALT).all())
              and bool((s.th.ticket[i] < 0).all()) and leftover == 0
              and int(s.g.commits[i]) > 0)
        emit("engine_invariants", check="drain", protocol=proto,
             commits=int(s.g.commits[i]), iters=int(s.g.iters[i]),
             leftover=leftover, ok=ok)
        assert ok, ("drain invariants", proto)
    s = packs["oracle"].result()
    for i, proto in enumerate(ORACLE_PROTOCOLS):
        got = extract_globals(proto, 128, s.g, lane=i).tps
        want = predicted_tps(proto, 128, CostModel())
        ok = abs(got - want) <= 0.15 * want
        emit("engine_invariants", check="oracle", protocol=proto, tps=got,
             predicted=want, ok=ok)
        assert ok, ("oracle", proto, got, want)


def worker_pool(n: int):
    """``n`` spawned worker processes (:func:`_worker_init`)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(n, multiprocessing.get_context("spawn"),
                               initializer=_worker_init)


def lane_accounting(g, lane: int, T: int) -> None:
    """Tick conservation and the ca/lock_wait identity on one lane of a
    pack's Globals (attribution on)."""
    from repro_torch.core.lock import engine
    tb = g.tb[lane].to(torch.int64)
    now = int(g.now[lane])
    assert int(tb.sum()) % 2**32 == (T * now) % 2**32, ("conservation", lane)
    wait = int(g.ca[lane, engine.CA_WAIT].to(torch.int64).sum())
    assert wait == int(tb[:, engine.TB_LOCKWAIT].sum()), ("ca/lock_wait", lane)


def phase_batch_width(widths=(1, 2, 4, 8, 16), T=1024, R=1_000_000,
                      iters=200) -> list[dict]:
    """One pack of hotspot_update at full width (txn_len 8, the six
    protocols cycled over the lanes, attribution on) stepped through
    ``engine._run_batch`` for ``iters`` iterations a lane (``max_iters``;
    the 2,000,000-tick horizon is never reached) at each width G."""
    from repro_torch.core.lock import WorkloadSpec, CostModel, engine
    hot = WorkloadSpec(kind="hotspot_update", txn_len=8, n_rows=R)
    out = []
    for G in widths:
        parts = [engine.split_config(engine.EngineConfig(
            protocol=engine.protocol_params(PROTOCOLS[i % len(PROTOCOLS)]),
            costs=CostModel(), workload=hot, n_threads=T,
            horizon=2_000_000, max_iters=iters, attrib=True),
            device="cuda") for i in range(G)]
        stat = parts[0][0]
        dps = engine.stack_lanes([dp for _, dp in parts])
        s0 = engine.stack_lanes([engine.init_state_dyn(stat, dp)
                                 for _, dp in parts])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = engine._run_batch(stat, dps, s0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert s.g.iters.tolist() == [iters] * G, s.g.iters.tolist()
        for lane in range(G):
            lane_accounting(s.g, lane, T)
        row = dict(lanes=G, threads=T, rows=R, txn_len=8, iters_per_lane=iters,
                   commits=s.g.commits.tolist(), wall_s=wall,
                   ms_per_batched_iter=1e3 * wall / iters,
                   ms_per_lane_iter=1e3 * wall / (iters * G),
                   peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit("batch_width", **row)
        out.append(row)
        del s, s0, dps, parts
    return out


def fig8_points(horizon: int, R: int = 1_000_000, threads=(1, 64, 256, 1024),
                api=None):
    """``benchmarks/fig08_scalability.py``'s quick grid on a SysBench
    ``--table-size=1000000`` table."""
    a = api or port_api()
    hot = a.lock.WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=R)
    return a.sweep.grid(["mysql", "o1", "o2", "group", "bamboo", "aria"],
                        hot, list(threads), horizon=horizon,
                        name_fmt="fig8_{protocol}_T{n_threads}")


def phase_sweep(ref: dict, horizon: int, R: int = 1_000_000,
                threads=(1, 64, 256, 1024)) -> dict:
    """Figure 8's grid through the port's ``run_sweep`` at the card's
    default lane width; at the fixture's horizon, every point's record held
    to the fixture's ``fig8`` (the reference's per-config run)."""
    from repro_torch.core.lock import TICKS_PER_SEC
    from repro_torch.core.lock.convert import sim_record
    from repro_torch.sweep import run_sweep
    from repro_torch.sweep.runner import CUDA_CHUNK, _bucket_key
    pts = fig8_points(horizon, R, threads)
    entry = ref["fig8"]
    held = horizon == entry["horizon"] and (R, tuple(threads)) == (
        1_000_000, (1, 64, 256, 1024))
    if held:
        check_configs(entry["points"], {p.name: p for p in pts}, "fig8")
    res = run_sweep(pts, device="cuda")
    for b in res.buckets:
        emit("sweep", bucket=f"{b.family}/{b.kind}/R{b.n_rows}",
             pad_threads=b.pad_threads, points=b.n_points, calls=b.n_chunks,
             repacks=b.n_repacks, lane_iters=b.lane_iters, wall_s=b.wall_s)
    tps = {}
    for p in pts:
        r = res[p.name]
        tps[p.protocol, p.n_threads] = r.tps
        emit("sweep", point=p.name, commits=r.commits, tps=r.tps,
             iters=r.iters, abort_rate=r.abort_rate)
        assert r.commits > 0 and np.isfinite(r.tps), p.name
        if p.protocol == "aria":
            continue
        # tick conservation on the padded lane; attribution is off in a
        # sweep (a point carries no attrib flag), so no contention records
        pad_t = _bucket_key(p, "pow2")[3]
        now = round(r.sim_seconds * TICKS_PER_SEC)
        assert sum(r.breakdown.values()) % 2**32 == (pad_t * now) % 2**32, \
            ("conservation", p.name)
        assert r.hotspots == [], p.name
    # tests/test_lock_engine.py::TestParserShapes and TestAria at the grid's
    # thread counts
    ratios = {
        "mysql_256_below_half_serial":
            tps["mysql", 256] < 0.5 * tps["mysql", 1],
        "o1_over_1.5x_mysql_256":
            tps["o1", 256] > 1.5 * tps["mysql", 256],
        "o2_flat_64_1024": abs(tps["o2", 64] - tps["o2", 1024])
            < 0.1 * tps["o2", 64],
        "group_over_2x_o2_256": tps["group", 256] > 2 * tps["o2", 256],
        "group_over_5x_mysql_256":
            tps["group", 256] > 5 * tps["mysql", 256],
        "group_over_2x_bamboo_256":
            tps["group", 256] > 2 * tps["bamboo", 256],
        "group_equals_o2_1":
            abs(tps["group", 1] - tps["o2", 1]) < 1e-6,
        "bamboo_over_1.5x_mysql_64":
            tps["bamboo", 64] > 1.5 * tps["mysql", 64],
        "bamboo_below_half_group_1024":
            tps["bamboo", 1024] < 0.5 * tps["group", 1024],
        "aria_flat_64_1024": abs(tps["aria", 64] - tps["aria", 1024])
            <= 0.05 * tps["aria", 1024],
        "aria_abort_over_0.9_T64_up": all(
            res[p.name].abort_rate > 0.9 for p in pts
            if p.protocol == "aria" and p.n_threads >= 64),
    }
    emit("sweep", check="ratios", **ratios)
    assert all(ratios.values()), ratios
    want = entry["points"]
    diff = ([p.name for p in pts
             if not same(sim_record(res[p.name]), want[p.name]["record"])]
            if held else None)
    emit("sweep", check="reference", points=len(pts), held=held,
         fixture_horizon=entry["horizon"], differing=diff)
    assert not diff, ("Figure 8's records vs the reference", diff)
    row = dict(points=len(pts), horizon=horizon, rows=R, lane_width=CUDA_CHUNK,
               wall_s=res.wall_s, lane_iters=res.lane_iters,
               repacks=res.n_repacks, n_compiles=res.n_compiles)
    emit("sweep", **row)
    return row


def _diff(a, b, prefix="") -> list[str]:
    """Names of the leaves of two numpy trees that differ (dtype or
    value)."""
    out = []
    for f, x, y in zip(a._fields, a, b):
        if isinstance(x, tuple):
            out += _diff(x, y, prefix + f + ".")
        elif not (x.dtype == y.dtype and np.array_equal(x, y)):
            out.append(prefix + f)
    return out


# Lanes of sweep_vs_single's grid on which the reference's own 4-segment
# run departs from its single-shot run beyond its iters caveat (ROADMAP
# queue 3), by horizon: an injected abort's cascade pends one iteration
# while the single-shot run's idle jump reaches the horizon, and a boundary
# inside that jump fires it. Found by running the reference's run_segment
# and single-shot loop on the CPU over the whole grid: one lane departs by
# 10,000 ticks, four by 20,000. The port reproduces the reference on them
# (CPU tests), so here their card runs are held to the port's CPU runs.
SEGMENT_FAULT_LANES = {
    10_000: ("bamboo_T8_p0.05",),
}


def _single_shape(p, R: int, device: str):
    """A sweep point's static shape and dynamic config at its bucket's
    padded shape."""
    from repro_torch.core.lock import engine, aria
    from repro_torch.sweep.runner import _bucket_key, _engine_config
    key = _bucket_key(p, "pow2")
    stat = engine.StaticShape(p.workload.kind, key[3], key[4], R)
    if p.protocol == "aria":
        return stat, aria.split_aria(aria.AriaConfig(
            p.workload, p.costs, p.n_threads, p.horizon), key[3], key[4],
            device=device)[1]
    return stat, engine.split_config(_engine_config(p), key[3], key[4],
                                      device=device)[1]


def _worker_init() -> None:
    """A single-lane worker: the port on its path, one CPU thread, the card
    reached before the first run."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    torch.cuda.init()
    import repro_torch.sweep  # noqa: F401


def _single_lane_run(p, R: int, device: str = "cuda"):
    """One sweep point alone (``engine._run_dyn``, the loop of ``run_sim``,
    or Aria's) at its bucket's padded shape: its name, metrics and final
    state as numpy."""
    from repro_torch.core.lock import engine, aria, extract
    from repro_torch.core.lock.convert import state_to_numpy
    stat, dp = _single_shape(p, R, device)
    if p.protocol == "aria":
        s = aria._run_dyn(stat, dp)
        want = aria.extract_aria(p.n_threads, s)
    else:
        s = engine._run_dyn(stat, dp, engine.init_state_dyn(stat, dp))
        want = extract(p.protocol, p.n_threads, s)
    return p.name, want, state_to_numpy(s)


def phase_sweep_vs_single(R=4096, horizon=10_000, threads=(8, 40, 64),
                          width=8, n_seg=4) -> tuple:
    """A mixed grid run three ways on the card — compacted at ``width``,
    sort-then-cut, and in ``n_seg`` segments (packed ``run_segment``) —
    against each lane's single-lane run (:func:`_single_lane_run`). The
    horizon was cut from 20,000 to 10,000 ticks for the time limit when the
    governor and serving phases came in. The single-lane runs go to
    :data:`SINGLE_LANE_WORKERS` processes on the same card, started first;
    this process runs the packs meanwhile. Returns the grid and its
    compacted run."""
    import dataclasses as dc
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.core.lock import WorkloadSpec, engine, aria
    from repro_torch.core.lock.convert import state_to_numpy
    from repro_torch.sweep import grid, point, run_sweep
    from repro_torch.sweep.runner import (_engine_config, _pack,
                                          run_packed_segment)
    fault_lanes = SEGMENT_FAULT_LANES[horizon]
    wl = WorkloadSpec(kind="hotspot_update", txn_len=1, n_rows=R)
    pts = (grid(list(PROTOCOLS), wl, list(threads), horizon=horizon,
                p_abort=[0.0, 0.05],
                name_fmt="{protocol}_T{n_threads}_p{p_abort}")
           + grid("aria", wl, list(threads), horizon=horizon)
           + [point("group", wl, threads[1], horizon=horizon, p_abort=0.05,
                    drain=True, name="drain_group")])
    t_single = time.perf_counter()
    pool = ProcessPoolExecutor(SINGLE_LANE_WORKERS,
                               multiprocessing.get_context("spawn"),
                               initializer=_worker_init)
    try:
        runs = [pool.submit(_single_lane_run, p, R) for p in pts]
        ways = {"compacted": run_sweep(pts, chunk_size=width, compact=True,
                                       device="cuda"),
                "sort_then_cut": run_sweep(pts, chunk_size=width,
                                           compact=False, device="cuda")}
        for name, res in ways.items():
            emit("sweep_vs_single", way=name, points=len(pts),
                 wall_s=res.wall_s, lane_iters=res.lane_iters,
                 repacks=res.n_repacks)

        def untils_of(p, k):
            stop = (engine.stop_ticks(_engine_config(p))
                    if p.protocol != "aria" else p.horizon)
            return horizon * k // n_seg if k < n_seg else stop

        # segmented: packs of `width` lanes per family, n_seg boundaries
        t0 = time.perf_counter()
        shapes = {p.name: _single_shape(p, R, "cuda") for p in pts}
        segmented = {}
        for fam in ("engine", "aria"):
            fpts = [p for p in pts
                    if (p.protocol == "aria") == (fam == "aria")]
            for lo in range(0, len(fpts), width):
                chunk = fpts[lo:lo + width]
                stat = shapes[chunk[0].name][0]
                dps = [shapes[p.name][1] for p in chunk]
                if fam == "engine":
                    states = [engine.init_state_dyn(stat, dp) for dp in dps]
                    packed = None
                    for k in range(1, n_seg + 1):
                        packed, _, g = run_packed_segment(
                            stat, dps, states,
                            [untils_of(p, k) for p in chunk], packed=packed)
                    outs = [engine.take_lane(packed, i) if g > 1 else packed
                            for i in range(len(chunk))]
                else:
                    s = _pack([aria.init_aria_state(stat, "cuda")]
                              * len(chunk), len(chunk))
                    for k in range(1, n_seg + 1):
                        s = aria._run_seg_batch(
                            stat, _pack(dps, len(chunk)), s,
                            [untils_of(p, k) for p in chunk])
                    outs = [engine.take_lane(s, i) for i in range(len(chunk))]
                for p, out in zip(chunk, outs):
                    segmented[p.name] = state_to_numpy(out)
        emit("sweep_vs_single", way="segmented", segments=n_seg,
             points=len(pts), wall_s=time.perf_counter() - t0)
        singles = {}
        for run in runs:
            name, want, state = run.result()
            singles[name] = (want, state)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    emit("sweep_vs_single", way="single_lane", points=len(pts),
         workers=SINGLE_LANE_WORKERS,
         wall_s=time.perf_counter() - t_single)
    metric_diff = [f"{name}:{p.name}.{f}"
                   for p in pts for name, res in ways.items()
                   for f, v in dc.asdict(singles[p.name][0]).items()
                   if dc.asdict(res[p.name])[f] != v]
    seg_diff, fault_diff = [], {}
    for p in pts:
        want, got = singles[p.name][1], segmented[p.name]
        diff = _diff(want, got)
        if p.protocol != "aria" and diff == ["g.iters"]:
            # the reference's caveat: one extra iteration per boundary
            # inside a fully idle stall window
            if 0 <= int(got.g.iters) - int(want.g.iters) <= n_seg - 1:
                diff = []
        if p.name in fault_lanes:
            fault_diff[p.name] = diff
        else:
            seg_diff += [f"{p.name}.{d}" for d in diff]
    # the reference's fault lanes: the card's segmented run against the
    # port's segmented run of the same lane on the CPU
    cpu_diff = []
    for p in pts:
        if p.name not in fault_lanes:
            continue
        stat, dp = _single_shape(p, R, "cpu")
        s = engine.init_state_dyn(stat, dp)
        for k in range(1, n_seg + 1):
            s, _ = engine.run_segment(stat, dp, s, untils_of(p, k))
        cpu_diff += [f"{p.name}.{d}" for d in
                     _diff(state_to_numpy(s), segmented[p.name])]
    emit("sweep_vs_single", check="differing", points=len(pts),
         metric_diff=metric_diff, segmented_leaf_diff=seg_diff,
         reference_fault_lanes_vs_single_shot=fault_diff,
         reference_fault_lanes_card_vs_cpu=cpu_diff)
    assert not metric_diff and not seg_diff and not cpu_diff, \
        (metric_diff, seg_diff, cpu_diff)
    return pts, ways["compacted"]


# the shards phase: two worker processes on the one card for the lane split,
# two sharded train steps; the prefill on the one-rank mesh does the model
# phase's arithmetic with its kernel, weights and tokens, so its logits must
# equal the model phase's bit for bit
SHARD_DEVICES = ["cuda:0", "cuda:0"]
SHARD_TRAIN_STEPS = 2


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_shards(sweep_pts, sweep_res, train_losses, cfg, params,
                 prefill_logits, moe_ref, seed: int) -> None:
    """Execution across devices on one card (see the module docstring):
    the lane split against ``sweep_res`` (sweep_vs_single's compacted run of
    ``sweep_pts``), then, on a one-rank NCCL group, FSDP+TP train steps
    against ``train_losses``, a tensor-parallel prefill against
    ``prefill_logits``, and the MoE layer on the mesh against ``moe_ref``
    (the models phase's deterministic prefill logits, the train phase's
    smoke-size card losses: :func:`shards_moe`)."""
    import torch.distributed as dist
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import distribute, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step, whole
    from repro_torch.launch.train import train
    from repro_torch.models import lm_spec
    from repro_torch.sweep import run_sweep
    t_phase = time.perf_counter()
    res = run_sweep(sweep_pts, chunk_size=8, compact=True, device="cuda",
                    devices=SHARD_DEVICES)
    differing = [p.name for p in sweep_pts
                 if res[p.name].__dict__ != sweep_res[p.name].__dict__]
    emit("shards", check="sweep", devices=SHARD_DEVICES,
         points=len(sweep_pts), wall_s=res.wall_s,
         unsharded_wall_s=sweep_res.wall_s,
         lane_iters=res.lane_iters, unsharded_lane_iters=sweep_res.lane_iters,
         differing=differing,
         note="wall includes spawning the two worker processes")
    assert not differing, differing

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(1)
        B, S = TRAIN_SHAPE
        records = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = train(TRAIN_ARCH, False, SHARD_TRAIN_STEPS, B, S, None,
                       model_axis=1, log_every=100, device="cuda",
                       on_step=records.append)
        want = train_losses[:SHARD_TRAIN_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        emit("shards", check="fsdp_tp_train", mesh=dict(
            zip(mesh.mesh_dim_names, mesh.shape)), batch=B, seq_len=S,
            losses=losses, unsharded_losses=want, loss_rel=rel,
            ms=[1e3 * r["seconds"] for r in records],
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            note="a train phase's first step ran cold too; bar "
                 "TRAIN_LOSS_TOL relative")
        assert max(rel) <= TRAIN_LOSS_TOL, (losses, want)

        shape = SHAPES["prefill_32k"]
        S = shape.seq_len
        sp = distribute(params, param_shardings(lm_spec(cfg), mesh,
                                                "serve"))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                               device="cuda")
        step = make_prefill_step(cfg, use_kernel=True,
                                 max_len=S + DECODE_STEPS, mesh=mesh)
        t0 = time.perf_counter()
        logits, caches = step(sp, {"tokens": tokens})
        logits = whole(logits).float().cpu()
        prefill_s = time.perf_counter() - t0
        err = float((logits - prefill_logits).abs().max()
                    / prefill_logits.abs().max())
        emit("shards", check="tp_prefill", seq_len=S, prefill_s=prefill_s,
             rel_err=err, equal=torch.equal(logits, prefill_logits),
             cache_placement=str(caches["g0"]["u0"][0].k.placements),
             note="against the model phase's prefill, same weights and "
                  "tokens")
        assert torch.equal(logits, prefill_logits), err
        del sp, caches
        shards_moe(mesh, moe_ref, seed)
    finally:
        dist.destroy_process_group()
    emit("shards", check="wall", seconds=time.perf_counter() - t_phase)


SHARD_MOE_DECODE_STEPS = 8
SHARD_MOE_ARCHS = ("deepseek-v2-lite-16b", "arctic-480b")


def _place_shared(params, shardings):
    """``params`` as DTensors of ``shardings``' placements on a one-rank
    mesh: each rank's shard is the whole tensor, so ``DTensor.from_local``
    keeps the storage (no second copy of the weights)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import Sharding
    if isinstance(shardings, Sharding):
        return DTensor.from_local(params, shardings.mesh,
                                  shardings.placements, run_check=False)
    if isinstance(params, dict):
        return {k: _place_shared(v, shardings[k]) for k, v in params.items()}
    return [_place_shared(v, sh) for v, sh in zip(params, shardings)]


def _moe_serve_run(cfg, params, tokens, mesh):
    """A prefill of ``tokens`` (``cfg``'s attn_chunk) and
    SHARD_MOE_DECODE_STEPS greedy decode steps, on one device or on
    ``mesh``: logits (host, f32), tokens, each MoE layer's drops, prefill
    s, decode ms a step."""
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, whole)
    from repro_torch.models.moe import MoEStatsLog
    B, S = tokens.shape
    torch.cuda.synchronize()
    with MoEStatsLog() as log:
        t0 = time.perf_counter()
        logits, caches = make_prefill_step(
            cfg, use_kernel=True, max_len=S + SHARD_MOE_DECODE_STEPS,
            mesh=mesh)(params, {"tokens": tokens})
        logits = whole(logits)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    drops = [int(whole(st.dropped)) for st in log.stats]
    serve = make_serve_step(cfg, mesh=mesh)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks = [nxt]
    t0 = time.perf_counter()
    for i in range(SHARD_MOE_DECODE_STEPS):
        nxt, caches = serve(params, {"tokens": nxt[:, None],
                                     "caches": caches, "pos": S + i})
        nxt = whole(nxt)
        toks.append(nxt)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / SHARD_MOE_DECODE_STEPS
    return dict(logits=logits.float().cpu(),
                tokens=torch.stack(toks, 1).cpu(), drops=drops,
                prefill_s=prefill_s, decode_ms=decode_ms)


def shards_moe(mesh, moe_ref, seed: int) -> None:
    """The MoE layer on the one-rank mesh (see the module docstring):
    full-width deepseek-v2-lite-16b serving against one device and the
    models phase, then smoke-size FSDP+TP steps of the MoE architectures
    against the train phase's card steps and one device."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  distribute,
                                                  param_shardings)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, lm_spec
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(MODELS_ARCH),
                              attn_chunk=MODELS_ATTN_CHUNK)
    torch.cuda.empty_cache()
    params = init_params(lm_spec(cfg), seed, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (1, MODELS_SEQ), generator=gen,
                           device="cuda")
    runs, peaks = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, m in (("one_device", None), ("mesh", mesh)):
            p = params if m is None else _place_shared(
                params, param_shardings(lm_spec(cfg), m, "serve"))
            torch.cuda.reset_peak_memory_stats()
            runs[name] = _moe_serve_run(cfg, p, tokens, m)
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
            del p
    finally:
        torch.use_deterministic_algorithms(False)
    one, sh = runs["one_device"], runs["mesh"]
    equal = torch.equal(sh["logits"], one["logits"])
    models_equal = torch.equal(one["logits"], moe_ref["logits"])
    emit("shards", check="moe_tp_serve", arch=MODELS_ARCH, batch=1,
         seq_len=MODELS_SEQ, attn_chunk=MODELS_ATTN_CHUNK,
         act_dtype=cfg.act_dtype, deterministic=True,
         logits_equal=equal, logits_equal_models_phase=models_equal,
         rel_err=_rel_err(sh["logits"], one["logits"]),
         decode_steps=SHARD_MOE_DECODE_STEPS,
         tokens_equal=torch.equal(sh["tokens"], one["tokens"]),
         tokens=sh["tokens"][0].tolist(),
         drops_equal=sh["drops"] == one["drops"], moe_layers=len(sh["drops"]),
         dropped_all_layers=sum(sh["drops"]),
         prefill_s=sh["prefill_s"], one_device_prefill_s=one["prefill_s"],
         decode_ms_per_step=sh["decode_ms"],
         one_device_decode_ms_per_step=one["decode_ms"],
         peak_memory_gib=peaks["mesh"],
         one_device_peak_memory_gib=peaks["one_device"],
         note="weights placed by DTensor.from_local (storage shared); "
              "times include each run's first call")
    assert equal and models_equal, (equal, models_equal)
    assert torch.equal(sh["tokens"], one["tokens"]), (sh["tokens"],
                                                      one["tokens"])
    assert sh["drops"] == one["drops"] and len(sh["drops"]) == sum(
        reps for unit, reps in cfg.layout for _, m in unit if "moe" in m)
    del params, runs
    torch.cuda.empty_cache()

    for arch in SHARD_MOE_ARCHS:
        a_cfg = dataclasses.replace(get_config(arch, smoke=True),
                                    act_dtype="float32")
        base = _to(init_params(lm_spec(a_cfg), seed, device="cpu"), "cuda")
        batch, _ = make_batch(DataConfig(seed=seed), a_cfg,
                              *TRAIN_CHECK_SHAPE, init_state(), device="cuda")
        losses = {}
        for name, m in (("one_device", None), ("mesh", mesh)):
            p, b = base, batch
            if m is not None:
                p = distribute(base, param_shardings(lm_spec(a_cfg), m,
                                                     "train"))
                b = distribute(batch, batch_shardings(batch, m))
            opt = adamw.init(p)
            step = make_train_step(a_cfg, adamw.AdamWConfig(
                **FIXED_OPT_SMOKE), mesh=m)
            losses[name] = []
            for _ in range(SHARD_TRAIN_STEPS):
                p, opt, met = step(p, opt, b)
                losses[name].append(float(met["loss"]))
        want = [moe_ref["train_losses"][arch]] + losses["one_device"][1:]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["mesh"], want)]
        emit("shards", check="moe_fsdp_tp_train", arch=arch,
             act_dtype="float32", batch=TRAIN_CHECK_SHAPE[0],
             seq_len=TRAIN_CHECK_SHAPE[1], losses=losses["mesh"],
             want=want, one_device_losses=losses["one_device"],
             loss_rel=rel, tol=TRAIN_LOSS_TOL,
             note="step 1 against the train phase's card step, step 2 "
                  "against one device; the same batch both steps")
        assert max(rel) <= TRAIN_LOSS_TOL, (arch, losses, want)


# a governed or served lane's iterations may exceed its single-shot run's by
# at most this (one per inner boundary inside an idle window: 4 segments)
ITERS_SLACK = 3


def _lane_vs_single(got, want) -> tuple[list[str], int]:
    """Differing ``SimResult`` fields (label and ``iters`` aside) and the
    ``iters`` difference of a segmented lane against a single-shot run."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    diff = [f for f in w if f not in ("protocol", "iters") and g[f] != w[f]]
    return diff, g["iters"] - w["iters"]


def _segment_accounting(res, name: str, pad_t: int) -> None:
    """The segments of one lane add up: commits to the total, windows to
    the run's length, and every window's ticks are conserved."""
    segs = res.segments[name]
    assert sum(s["commits"] for s in segs) == res[name].commits, name
    assert [s["t0"] for s in segs] == [0] + [s["t1"] for s in segs[:-1]], \
        ("windows", name)
    for s in segs:
        assert sum(s["breakdown"].values()) == pad_t * (s["t1"] - s["t0"]), \
            ("conservation", name, s["index"])


def _packed_ms(res, wall: float) -> dict:
    """Packed iterations of a governed or served run (each bucket's
    lane-iterations over its pack width, the pow2 width of its lane groups)
    and the wall per one."""
    packed = sum(b.lane_iters / (1 << (-(-b.n_points // b.n_chunks) - 1)
                                 .bit_length()) for b in res.buckets)
    return dict(lane_iters=res.lane_iters, packed_iters=packed,
                ms_per_packed_iter=1e3 * wall / max(packed, 1))


def phase_governed(single: dict, horizon: int, n_seg: int = 4,
                   T: int = 1024, R: int = 1_000_000) -> dict:
    """``run_governed`` at full width: the engine phase's table and pool
    (hotspot update, txn_len 8, attribution on) under stationary drift in
    ``n_seg`` segments over the engine phase's horizon, one pack of 8 lanes
    (a FixedPolicy per protocol, the queue rule, epsilon-greedy). Each fixed
    lane equals the engine phase's single-shot run of its protocol, field
    for field, ``iters`` within 0..3; every lane's segments add up."""
    from repro_torch.adaptive import (EpsilonGreedyPolicy, FixedPolicy,
                                      GovernorCell, QueueRulePolicy,
                                      preset_timeline, run_governed)
    from repro_torch.core.lock import WorkloadSpec, stationary
    drift = stationary(WorkloadSpec(kind="hotspot_update", txn_len=8,
                                    n_rows=R), n_seg)
    cells = ([GovernorCell(f"fixed_{p}", FixedPolicy(p), drift, T,
                           attrib=True) for p in PROTOCOLS]
             + [GovernorCell("rule", QueueRulePolicy(), drift, T,
                             attrib=True),
                GovernorCell("greedy", EpsilonGreedyPolicy(), drift, T,
                             attrib=True)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_governed(cells, horizon=horizon, n_segments=n_seg,
                       device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = {}
    for p in PROTOCOLS:
        diff, d_iters = _lane_vs_single(res[f"fixed_{p}"], single[p])
        emit("governed", lane=f"fixed_{p}", commits=res[f"fixed_{p}"].commits,
             iters=res[f"fixed_{p}"].iters, single_iters=single[p].iters,
             differing_fields=diff)
        if diff or not 0 <= d_iters <= ITERS_SLACK:
            bad[p] = (diff, d_iters)
    for c in cells:
        _segment_accounting(res, c.name, T)
    row = dict(lanes=len(cells), threads=T, rows=R, horizon=horizon,
               segments=n_seg, wall_s=wall, wall_s_per_segment=wall / n_seg,
               **_packed_ms(res, wall),
               rule_timeline=preset_timeline(res, "rule"),
               greedy_timeline=preset_timeline(res, "greedy"),
               commits={c.name: res[c.name].commits for c in cells},
               n_compiles=res.n_compiles)
    emit("governed", **row)
    assert not bad, ("governed lanes vs single-shot runs", bad)
    return row


def phase_serving(single: dict, horizon: int, n_bounds: int = 4,
                  T: int = 1024, R: int = 1_000_000) -> dict:
    """``serve`` at full width: the engine phase's table and pool under a
    saturating schedule (every request at tick 0, admission ``wait``, 64
    credits a slot, which no slot exhausts), ``n_bounds`` boundaries, the
    six protocols as one pack. Each lane equals the engine phase's run of
    its protocol as in the governed phase; completions equal commits
    (``p_abort`` 0) and the response histogram holds every completion
    (``serve`` asserts it per cell; the raw responses are counted here)."""
    from repro_torch.core.lock import WorkloadSpec
    from repro_torch.serving import ServeCell, saturating, serve
    hot = WorkloadSpec(kind="hotspot_update", txn_len=8, n_rows=R)
    credits = 64
    sched = saturating(T * credits, horizon)
    cells = [ServeCell(name=p, schedule=sched, workload=hot, n_threads=T,
                       preset=p, admission="wait", max_outstanding=credits,
                       attrib=True) for p in PROTOCOLS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve(cells, seg_ticks=horizon // n_bounds, keep_responses=True,
                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = {}
    for p in PROTOCOLS:
        s = res.serving[p]
        diff, d_iters = _lane_vs_single(res[p], single[p])
        emit("serving", lane=p, completed=s.completed,
             commits=res[p].commits, iters=res[p].iters,
             single_iters=single[p].iters, p50_us=s.p50_us, p99_us=s.p99_us,
             max_us=s.max_us, differing_fields=diff)
        if diff or not 0 <= d_iters <= ITERS_SLACK:
            bad[p] = (diff, d_iters)
        assert s.completed == res[p].commits, (p, s.completed)
        assert len(res.responses[p]) == s.completed, p
        assert s.arrived == T * credits and s.in_flight_end > 0, p
        _segment_accounting(res, p, T)
    row = dict(lanes=len(cells), threads=T, rows=R, horizon=horizon,
               boundaries=n_bounds, wall_s=wall,
               wall_s_per_segment=wall / n_bounds, **_packed_ms(res, wall),
               completed={p: res.serving[p].completed for p in PROTOCOLS},
               n_compiles=res.n_compiles)
    emit("serving", **row)
    assert not bad, ("served lanes vs single-shot runs", bad)
    return row


def phase_adaptive_serving_vs_ref(ref: dict) -> None:
    """Small packs on the card, every record held to the fixture's
    ``governed_served`` (the reference's runs): :func:`governed_spec` (the
    batched-lanes case of tests/test_adaptive.py at its 30,000 ticks) and
    :func:`served_spec` (an open-load pack at TestAdmission's 20,000
    ticks, slots revived)."""
    from repro_torch.adaptive import run_governed
    from repro_torch.core.lock.convert import config_doc
    from repro_torch.serving import serve
    entry = ref["governed_served"]
    gspec, sspec = governed_spec(), served_spec()
    assert same(config_doc(gspec), entry["governed"]["config"]), \
        "governed: config differs from the fixture's"
    assert same(config_doc(sspec), entry["served"]["config"]), \
        "served: config differs from the fixture's"
    t0 = time.perf_counter()
    gov = run_governed(**gspec, device="cuda")
    g_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = serve(**sspec, device="cuda")
    s_wall = time.perf_counter() - t0
    diff = []
    for kind, got in (("governed", governed_records(gov)),
                      ("served", served_records(srv))):
        want = entry[kind]["records"]
        assert sorted(got) == sorted(want), (kind, sorted(got))
        diff += [f"{kind}:{n}:{part}" for n in got for part in got[n]
                 if not same(got[n][part], want[n][part])]
    revived = {n: srv.serving[n].completed for n in srv.names()}
    emit("adaptive_serving_vs_ref", governed_cells=gov.names(),
         governed_horizon=gspec["horizon"], governed_wall_s=g_wall,
         serving_cells=srv.names(), served_horizon=SERVED_HORIZON,
         served_wall_s=s_wall, completed=revived,
         rejected={n: srv.serving[n].rejected for n in srv.names()},
         shed={n: srv.serving[n].shed for n in srv.names()},
         rule_timeline=[r["preset"] for r in srv.segments["rule"]],
         differing=diff)
    assert not diff, diff
    # more completions than a slot's credits can carry: slots were revived
    T = sspec["cells"][0].n_threads
    assert all(c > 2 * T for c in revived.values()), revived


def phase_fig15(horizon: int) -> dict:
    """fig15's ``skew_ramp`` scenario (benchmarks/fig15_adaptive.py, quick:
    Zipf ``txn_len`` 4, R=8192, T=64, 12 segments, the lock-manager-bound
    costs, three fixed protocols + rule + greedy) through ``run_governed``
    on the card at ``horizon`` ticks, for its wall."""
    from repro_torch.adaptive import (EpsilonGreedyPolicy, FixedPolicy,
                                      GovernorCell, QueueRulePolicy,
                                      preset_timeline, run_governed)
    from repro_torch.core.lock import CostModel, WorkloadSpec, skew_ramp
    cm = CostModel(op_exec=20, commit_base=30)
    n_seg, fixed = 12, ("mysql", "o2", "group")
    drift = skew_ramp(WorkloadSpec(kind="zipf", txn_len=4, n_rows=8192),
                      n_seg, lo=0.3, hi=0.7)
    cells = [GovernorCell(f"fig15_skew_ramp_{p}", FixedPolicy(p), drift, 64,
                          costs=cm) for p in fixed]
    cells += [GovernorCell("fig15_skew_ramp_rule", QueueRulePolicy(), drift,
                           64, costs=cm),
              GovernorCell("fig15_skew_ramp_greedy", EpsilonGreedyPolicy(),
                           drift, 64, costs=cm)]
    t0 = time.perf_counter()
    res = run_governed(cells, horizon=horizon, n_segments=n_seg,
                       device="cuda")
    wall = time.perf_counter() - t0
    best_name, best = max(((p, res[f"fig15_skew_ramp_{p}"].commits)
                           for p in fixed), key=lambda kv: kv[1])
    for c in cells:
        _segment_accounting(res, c.name, 64)
    out = dict(
        scenario="skew_ramp", horizon=horizon, segments=n_seg,
        wall_s=wall, **_packed_ms(res, wall),
        iters={c.name: res[c.name].iters for c in cells},
        commits={c.name: res[c.name].commits for c in cells},
        best_fixed=best_name,
        rule_vs_best=res["fig15_skew_ramp_rule"].commits / max(best, 1),
        greedy_vs_best=res["fig15_skew_ramp_greedy"].commits / max(best, 1),
        rule_timeline=preset_timeline(res, "fig15_skew_ramp_rule"),
        greedy_timeline=preset_timeline(res, "fig15_skew_ramp_greedy"))
    emit("fig15", **out)
    return out


def phase_fig_grids(fig17_horizon: int) -> dict:
    """fig17's quick grid (benchmarks/fig17_serving.py: mysql, group,
    brook2pl x rho 0.01, 0.05, 0.25, 1.0 of the uncontended mysql capacity;
    T=32, R=4096, Poisson seed 17, queue_cap 8T ``reject``, SLA 2,000 us, 24
    boundaries) at :data:`FIG17_HORIZON`, for its wall."""
    from repro_torch.core.lock import CostModel, WorkloadSpec, TICKS_PER_SEC
    from repro_torch.serving import (ServeCell, poisson, pool_capacity_tps,
                                     serve)
    hot = WorkloadSpec(kind="hotspot_update", txn_len=2, n_rows=4096)
    T, seg = 32, fig17_horizon // 24
    rhos, protos = (0.01, 0.05, 0.25, 1.0), ("mysql", "group", "brook2pl")
    cap = pool_capacity_tps(hot, CostModel(), T, "mysql")
    cells = []
    for proto in protos:
        for rho in rhos:
            rate = rho * cap / TICKS_PER_SEC
            cells.append(ServeCell(
                name=f"fig17_{proto}_rho{rho}",
                schedule=poisson(rate, fig17_horizon, seed=17),
                workload=hot, n_threads=T, preset=proto,
                queue_cap=8 * T, admission="reject",
                max_outstanding=max(8, int(2 * seg * rate / T) + 1),
                sla_us=2_000.0))
    t0 = time.perf_counter()
    res = serve(cells, seg_ticks=seg, device="cuda")
    wall = time.perf_counter() - t0
    for c in cells:
        s = res.serving[c.name]
        emit("fig_grids", figure="fig17", cell=c.name,
             offered_tps=s.offered_tps, goodput_tps=s.goodput_tps,
             p50_us=s.p50_us, p99_us=s.p99_us, p999_us=s.p999_us,
             max_us=s.max_us, sla_miss_frac=s.sla_miss_frac,
             rejected=s.rejected, iters=res[c.name].iters)
        assert s.p50_us <= s.p99_us <= s.p999_us <= s.max_us, c.name
        assert s.arrived == (s.rejected + s.shed + s.qlen_end
                             + s.completed + s.in_flight_end), c.name
    knees = {p: max(res.serving[f"fig17_{p}_rho{r}"].goodput_tps
                    for r in rhos) for p in protos}
    out = dict(horizon=fig17_horizon, boundaries=24, wall_s=wall,
               **_packed_ms(res, wall), knee_tps=knees,
               best=max(knees, key=knees.get))
    emit("fig_grids", figure="fig17", **out)
    return out


# the trace phase's protocols: the engine phase's runs short enough to trace
# in the time limit (47, 340, 164 and 733 iterations in PR 15's run)
TRACE_PROTOCOLS = ("mysql", "o2", "bamboo", "brook2pl")
# iterations of each profiled call in the prof phase (torch.profiler's event
# processing costs seconds a call at full width)
DEVICE_ITERS = 8
# the trace phase's traced-against-untraced run in turns (untraced, traced,
# traced, untraced): 340 iterations
TRACE_COST_PROTOCOL = "o2"


def _certify(ev: dict, proto: str, cfg):
    """The certificate of one run's events under its protocol, with the
    chop ranks of ``cfg`` (the port's split_config) for brook2pl."""
    from repro_torch.analysis import certify
    from repro_torch.core.lock import engine
    pp = cfg.protocol
    rank = (engine.split_config(cfg, device="cpu")[1].wl.acq_rank.tolist()
            if pp.ordered_acquire else None)
    return certify(ev, pp, acq_rank=rank)


def trace_calls(cfg, alloc: int) -> dict:
    """Torch calls per iteration of the untraced step and of the traced
    one (the events step and the record), on the card after 4 iterations
    from the initial state (tools/step_calls.py's counter)."""
    from step_calls import calls_per_iter
    from repro_torch.core.lock import engine
    from repro_torch.obs import make_trace
    from repro_torch.obs.trace import _Recorder
    stat, dp = engine.split_config(cfg, device="cuda")
    lp = engine._lanes(dp)
    step, step_ev = (engine._make_step(stat, lp),
                     engine._make_step_events(stat, lp))
    rec = _Recorder(make_trace(alloc, device="cuda"), stat.n_threads)

    def traced(s):
        s, ev = step_ev(s)
        rec(ev)
        return s

    s = engine._unsqueeze(engine.init_state_dyn(stat, dp))
    for _ in range(4):
        s = step(s)
    untraced_calls, _ = calls_per_iter(step, s)
    traced_calls, _ = calls_per_iter(traced, s)
    return dict(untraced_calls_per_iter=untraced_calls,
                traced_calls_per_iter=traced_calls)


def timed(fn):
    """``fn()`` and its wall in seconds, between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trace_cost_in_turns(cfg, traced, want, alloc: int):
    """Untraced, traced, traced and untraced runs of one config (``traced``
    runs it traced): emits their ms per iteration and the torch calls per
    iteration of each step; returns the first traced run and its wall."""
    from repro_torch.core.lock import engine, extract
    untraced = lambda: engine.run_sim(cfg, device="cuda")  # noqa: E731
    s0, wall_u1 = timed(untraced)
    first, wall_t1 = timed(traced)
    _, wall_t2 = timed(traced)
    s1, wall_u2 = timed(untraced)
    n = want.iters
    emit("trace", check="cost_in_turns", protocol=cfg.protocol.name,
         iters=n, order=["untraced", "traced", "traced", "untraced"],
         ms_per_iter=[1e3 * w / n for w in (wall_u1, wall_t1, wall_t2,
                                             wall_u2)],
         traced_ms_per_iter=1e3 * (wall_t1 + wall_t2) / (2 * n),
         untraced_ms_per_iter=1e3 * (wall_u1 + wall_u2) / (2 * n),
         **trace_calls(cfg, alloc))
    assert extract(cfg.protocol.name, cfg.n_threads, s0) == want
    assert extract(cfg.protocol.name, cfg.n_threads, s1) == want
    return first, wall_t1


def phase_trace(single: dict, untraced_ms: dict, horizon: int) -> None:
    """Traced runs at the engine phase's width and horizon, each held to the
    engine phase's untraced run of its protocol; for
    :data:`TRACE_COST_PROTOCOL`, untraced and traced runs in turns."""
    from repro_torch.analysis import total_trace_wait_ticks
    from repro_torch.core.lock import WorkloadSpec, extract, engine
    from repro_torch.obs import (EV_ABORT, EV_COMMIT, events_host,
                                 simulate_traced)
    T, R = 1024, 1_000_000
    hot = WorkloadSpec(kind="hotspot_update", txn_len=8, n_rows=R)
    for proto in TRACE_PROTOCOLS:
        want = single[proto]
        alloc = 8 * T * want.iters
        cfg = engine.EngineConfig(
            protocol=engine.protocol_params(proto), costs=engine.CostModel(),
            workload=hot, n_threads=T, horizon=horizon, attrib=True)
        traced = lambda: simulate_traced(  # noqa: E731
            proto, hot, T, horizon=horizon, attrib=True, cap=alloc,
            device="cuda")
        if proto == TRACE_COST_PROTOCOL:
            (s, tb), wall = trace_cost_in_turns(cfg, traced, want, alloc)
        else:
            (s, tb), wall = timed(traced)
        r = extract(proto, T, s)
        ev = events_host(tb)
        wait = total_trace_wait_ticks(ev)
        cert = _certify(ev, proto, cfg)
        commits = int((ev["ev"] == EV_COMMIT).sum())
        aborts = int((ev["ev"] == EV_ABORT).sum())
        emit("trace", protocol=proto, threads=T, rows=R, horizon=horizon,
             iters=r.iters, events=ev["n"], dropped=ev["dropped"],
             alloc=alloc, commit_events=commits, commits=r.commits,
             abort_events=aborts, trace_wait_ticks=wait,
             lock_wait_ticks=r.breakdown["lock_wait"],
             certified=cert.ok, mode=cert.mode, attempts=cert.n_attempts,
             ww_edges=cert.n_edges, wall_s=wall,
             traced_ms_per_iter=1e3 * wall / r.iters,
             untraced_ms_per_iter=untraced_ms[proto])
        assert r == want, (proto, "traced run != untraced run")
        assert ev["dropped"] == 0, proto
        assert commits == r.commits, proto
        assert aborts == r.user_aborts + r.forced_aborts, proto
        assert bool(np.all(np.diff(ev["ts"]) >= 0)), (proto, "time order")
        assert wait <= r.breakdown["lock_wait"], proto
        assert cert.ok, cert.text()
    s, tb = simulate_traced("mysql", hot, T, horizon=horizon, attrib=True,
                            trace_on=False, device="cuda")
    off_equal = extract("mysql", T, s) == single["mysql"]
    emit("trace", protocol="mysql", trace_on=False, stored=int(tb.n),
         equal_to_untraced=off_equal)
    assert off_equal and int(tb.n) == 0 and int(tb.dropped) == 0


def _trace_cli_run(proto: str, device: str):
    """trace_vs_cpu's run of one protocol: the certifier CLI's
    hotspot_update workload at seed 1. Returns the events, the Chrome-trace
    JSON and the final state as numpy."""
    from repro_torch.analysis import cli
    from repro_torch.core.lock.convert import state_to_numpy
    from repro_torch.obs import events_host, simulate_traced, to_chrome_trace
    over = {} if proto == "brook2pl" else dict(cli.TIMEOUT_OVER)
    s, tb = simulate_traced(proto, cli._workload("hotspot_update", 1),
                            cli.THREADS, horizon=cli.HORIZON, p_abort=0.05,
                            seed=1, cap=65_536, device=device, **over)
    ev = events_host(tb)
    return (ev, json.dumps(to_chrome_trace(ev, end=int(s.g.now))),
            state_to_numpy(s))


def phase_trace_vs_cpu() -> None:
    """The six protocols traced on the card and on the CPU, all twelve runs
    in :data:`CHECK_WORKERS` worker processes (brook2pl's, the longest,
    first); this process compares them and certifies the card's traces."""
    from repro_torch.analysis import cli
    from repro_torch.core.lock import engine
    order = ("brook2pl",) + tuple(p for p in PROTOCOLS if p != "brook2pl")
    t0 = time.perf_counter()
    with worker_pool(CHECK_WORKERS) as pool:
        runs = {(p, dev): pool.submit(_trace_cli_run, p, dev)
                for p in order for dev in ("cuda", "cpu")}
        for proto in PROTOCOLS:
            ev, doc, st = runs[proto, "cuda"].result()
            ev_cpu, doc_cpu, st_cpu = runs[proto, "cpu"].result()
            diff = [k for k in ("ts", "tid", "row", "ev")
                    if not np.array_equal(ev[k], ev_cpu[k])]
            diff += [k for k in ("n", "dropped", "cap")
                     if ev[k] != ev_cpu[k]]
            diff += _diff(st, st_cpu, "state.")
            over = {} if proto == "brook2pl" else dict(cli.TIMEOUT_OVER)
            cfg = engine.EngineConfig(
                protocol=engine.protocol_params(proto, **over),
                costs=engine.CostModel(),
                workload=cli._workload("hotspot_update", 1),
                n_threads=cli.THREADS, horizon=cli.HORIZON, p_abort=0.05,
                seed=1)
            cert = _certify(ev, proto, cfg)
            emit("trace_vs_cpu", protocol=proto, iters=int(st.g.iters),
                 events=ev["n"], differing=diff,
                 chrome_trace_equal=doc == doc_cpu, certified=cert.ok,
                 mode=cert.mode, committed=cert.n_committed,
                 aborted=cert.n_aborted)
            assert not diff and doc == doc_cpu, (proto, diff)
            assert cert.ok, cert.text()
    emit("trace_vs_cpu", runs=len(runs), workers=CHECK_WORKERS,
         wall_s=time.perf_counter() - t0)


def device_time(run, st, n_iters: int) -> dict:
    """One profiled call of ``run`` (``n_iters`` iterations from ``st``):
    the summed time of its device activities (kernels, copies, fills) from
    torch.profiler, per iteration, beside the call's wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    return dict(device_events_per_iter=len(dev) / n_iters,
                device_us_per_iter=busy_us / n_iters,
                profiled_us_per_iter=1e6 * wall / n_iters,
                busy_share_profiled=busy_us / (1e6 * wall))


def phase_prof(horizon: int, n_iters: int = 32, repeats: int = 3) -> None:
    """profile_step at the engine phase's full width for group and brook2pl,
    and the device-busy share of group's full step."""
    from repro_torch.core.lock import WorkloadSpec, engine
    from repro_torch.obs import profile_row, profile_step, rank_table
    from repro_torch.obs.prof import make_iter_runner
    from step_calls import calls_per_iter
    T, R = 1024, 1_000_000
    stages = engine.PROF_STAGES
    hot = WorkloadSpec(kind="hotspot_update", txn_len=8, n_rows=R)
    for proto in ("group", "brook2pl"):
        cfg = engine.EngineConfig(
            protocol=engine.protocol_params(proto), costs=engine.CostModel(),
            workload=hot, n_threads=T, horizon=horizon, attrib=True)
        t0 = time.perf_counter()
        prof = profile_step(cfg, n_iters=n_iters, repeats=repeats,
                            device="cuda")
        wall = time.perf_counter() - t0
        print(rank_table(prof), flush=True)
        row = dict(protocol=proto, threads=T, rows=R, n_iters=n_iters,
                   repeats=repeats, us_per_iter=prof.us_per_iter,
                   stages={r.stage: [r.us_per_iter, r.fraction]
                           for r in prof.stages},
                   dominant=prof.dominant.stage, compiles=prof.compiles,
                   csv=profile_row(f"prof_{proto}", prof), wall_s=wall)
        assert prof.compiles == len(engine.PROF_STAGES) + 1
        assert abs(sum(r.fraction for r in prof.stages) - 1.0) < 1e-9
        # torch calls per iteration of the full step and each ablation's
        # reduction, on the card's step from the warmed state
        stat, dp = engine.split_config(cfg, device="cuda")
        run = make_iter_runner(stat, dp, n_iters)
        warm = run(engine.init_state_dyn(stat, dp))
        lp, s1 = engine._lanes(dp), engine._unsqueeze(warm)

        def calls(ablate):
            step = engine._make_step(stat, lp, ablate=frozenset(ablate))
            return calls_per_iter(step, s1, 1)[0]

        full_calls = calls(())
        row.update(calls_per_iter=full_calls, calls_removed={
            k: full_calls - calls({k}) for k in stages})
        if proto == "group":
            # the device's share of the full step's wall, and the device
            # time each ablation removes (stable where the wall is not),
            # over DEVICE_ITERS iterations from the warmed state
            def dev(ablate):
                run = make_iter_runner(stat, dp, DEVICE_ITERS,
                                       frozenset(ablate))
                return device_time(run, warm, DEVICE_ITERS)

            busy = dev(())
            busy["busy_share_unprofiled"] = (busy["device_us_per_iter"]
                                             / prof.us_per_iter)
            row["device"] = busy
            row["device_us_removed"] = {
                k: busy["device_us_per_iter"] - dev({k})["device_us_per_iter"]
                for k in stages}
        emit("prof", **row)


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
    bw, f32_peak = rates[:2]
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
    prefill_32k's length, decode steps, serve_demo. Returns (cfg, params,
    the prefill's last-token logits on the host)."""
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
    prefill_logits = logits.float().cpu()
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
    return cfg, params, prefill_logits


# the models phase: deepseek-v2-lite-16b at full width (bf16), its prompt
# cut from prefill_32k's 32,768 x 32 to one prompt of 4,096 tokens, and the
# query-chunked attention at 1,024 rows a block against the dense one
MODELS_ARCH = "deepseek-v2-lite-16b"
MODELS_SEQ = 4_096
MODELS_ATTN_CHUNK = 1_024
# the other architectures, at their smoke configs in f32
SMOKE_ARCHS = ("deepseek-coder-33b", "gemma3-12b", "command-r-35b",
               "arctic-480b", "deepseek-v2-lite-16b", "recurrentgemma-2b",
               "musicgen-medium", "qwen2-vl-2b", "mamba2-1.3b")
SMOKE_ARCH_SHAPE = (2, 24)          # batch, prompt (test_decode_consistency)
# qwen2-0.5b's smoke config in bf16 on the kernel path (head dim 16: the
# wgmma kernel's D = 16 instance), a prompt over three 128-key tiles
SMOKE_BF16_SHAPE = (2, 333)
# the token-input architectures, whose smoke-size train steps the train
# phase runs on the card and the CPU
TRAIN_CHECK_ARCHS = ("qwen2-0.5b", "deepseek-coder-33b", "gemma3-12b",
                     "command-r-35b", "arctic-480b", "deepseek-v2-lite-16b",
                     "recurrentgemma-2b", "mamba2-1.3b")
# the chunked prefill against the dense one: test_decode_consistency's
# chunked-vs-dense bar, as last-token logits relative to max |logit|, with
# f32 activations over the same bf16 weights and deterministic algorithms.
# By default the MoE combine's index_add_ sums with atomics, so two dense
# prefills of one prompt differ run to run (8.3e-5 in f32, and up to
# percents in bf16, where MoE routing with ~73,000 capacity drops over the
# 26 layers amplifies a last bit); with deterministic algorithms chunked
# and dense prefills were equal bit for bit in f32 and bf16 (an H100 80GB
# HBM3 at 700 W). The bf16 pair is printed too
CHUNKED_TOL = 1e-4


def _to(tree, dev):
    """A parameter, input or cache tree (dicts, lists, NamedTuples) on
    ``dev``."""
    if isinstance(tree, dict):
        return {key: _to(val, dev) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_to(val, dev) for val in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_to(val, dev) for val in tree))
    return tree.to(dev)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for val in tree.values() for x in _leaves(val)]
    if isinstance(tree, (list, tuple)):
        return [x for val in tree for x in _leaves(val)]
    return [tree]


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


def _n_global(cfg) -> int:
    """Global (flash-kernel) attention layers of a config."""
    return sum(reps * sum(m == "global" for m, _ in unit)
               for unit, reps in cfg.layout)


def _arch_run(arch: str, seed: int, device: str) -> dict:
    """One smoke-size architecture in f32 on ``device``, weights from
    ``seed`` made on the CPU (so that both devices hold the same ones):
    prefill (kernel path) and one decode step at the default capacity
    factor, and at capacity factor 8 (no MoE drops) the same against the
    full forward. Returns numpy arrays and the flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import (decode_step, forward, init_params,
                                    lm_spec, prefill)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              act_dtype="float32")
    params = _to(init_params(lm_spec(cfg), seed, device="cpu"), device)
    B, S = SMOKE_ARCH_SHAPE
    rng = np.random.default_rng(seed)
    inp = {}
    if cfg.embed_inputs:
        inp["tokens"] = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    else:
        inp["embeds"] = rng.normal(size=(B, S + 1, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope:
        inp["positions3"] = np.sort(rng.integers(0, 3 * S, (3, B, S + 1)),
                                    axis=-1).astype(np.int32)
    inp = {k: torch.from_numpy(v).to(device) for k, v in inp.items()}

    def cut(sl):
        return {k: (v[:, :, sl] if k == "positions3" else v[:, sl])
                for k, v in inp.items()}

    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    before = flash_attention.launches
    out = {}
    for name, c in (("default", cfg),
                    ("cf8", dataclasses.replace(cfg, capacity_factor=8.0))):
        lp, caches = prefill(params, c, use_kernel=True, max_len=S + 1,
                             device=device, **cut(slice(0, S)))
        ld, caches = decode_step(params, c, caches=caches, pos=S,
                                 device=device, **cut(slice(S, S + 1)))
        out[name] = [host(lp), host(ld)] + [host(t) for t in _leaves(caches)]
    cfg_f = dataclasses.replace(cfg, capacity_factor=8.0, ssm_chunk=1) \
        if arch == "mamba2-1.3b" else dataclasses.replace(
            cfg, capacity_factor=8.0)
    full = forward(params, cfg_f, mode="prefill", device=device, **inp)
    out["full"] = host(full.logits[:, -1])
    out["launches"] = flash_attention.launches - before
    return out


def _arch_cpu_run(arch: str, seed: int) -> dict:
    """:func:`_arch_run` on the CPU, in a worker process."""
    return _arch_run(arch, seed, "cpu")


def phase_models(seed: int, cpu_runs: dict) -> dict:
    """deepseek-v2-lite-16b at full width in bf16 (prefill of one 4,096-
    token prompt, chunked against dense, 32 absorbed-MLA decode steps, a
    GroupServer of 12 requests), then the nine non-qwen2 architectures at
    their smoke configs on the card against their CPU runs (``cpu_runs``:
    futures by architecture), then qwen2-0.5b's smoke config in bf16 on the
    kernel path (:func:`smoke_bf16_prefill`). Returns the flash launches
    expected of it by route: each architecture's on the route the table
    gives f32 inputs at its head dim, qwen2's on wgmma, and the
    deterministic bf16 chunked prefill's logits (the shards phase holds its
    mesh prefill to them)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import flash_attention, route
    from repro_torch.kernels.flash_attention.ops import ROUTES
    from repro_torch.launch.serve import GroupServer, Request
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import count_params, init_params, lm_spec
    from repro_torch.models.moe import MoEStatsLog
    t_phase = time.perf_counter()
    cfg = get_config(MODELS_ARCH)
    shape = SHAPES["prefill_32k"]
    B, S = 1, MODELS_SEQ
    emit("models", check="cut", arch=MODELS_ARCH, shape=shape.name,
         seq_len=S, global_batch=shape.global_batch, batch=B,
         attn_chunk=MODELS_ATTN_CHUNK,
         note=f"prompt cut from {shape.seq_len} x {shape.global_batch} to "
              f"{S} x {B} to fit the time limit; weights bf16")
    t0 = time.perf_counter()
    params = init_params(lm_spec(cfg), seed, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(lm_spec(cfg))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    chunked = dataclasses.replace(cfg, attn_chunk=MODELS_ATTN_CHUNK)
    step = make_prefill_step(chunked, use_kernel=True,
                             max_len=S + DECODE_STEPS)
    step(params, {"tokens": tokens[:, :256]})          # first-call warm-up
    torch.cuda.synchronize()
    with MoEStatsLog() as log:
        t0 = time.perf_counter()
        logits, caches = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    assert logits.shape == (B, 1, cfg.padded_vocab), logits.shape
    assert bool(torch.isfinite(logits.float()).all()), "prefill logits"
    n_moe = sum(reps for unit, reps in cfg.layout for _, m in unit
                if "moe" in m)
    assert len(log.stats) == n_moe, (len(log.stats), n_moe)
    first = log.stats[0]
    drops = [int(st.dropped) for st in log.stats]
    assert int(first.expert_counts.sum()) == B * S * cfg.top_k
    emit("models", check="moe_drops", layer="g1/u0[0]",
         dropped=drops[0], assignments=B * S * cfg.top_k,
         capacity_factor=cfg.capacity_factor,
         expert_counts_max=int(first.expert_counts.max()),
         expert_counts_min=int(first.expert_counts.min()),
         dropped_all_layers=sum(drops))
    pair = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for act in ("float32", "bfloat16"):
            for chunk in (MODELS_ATTN_CHUNK, 0):
                c = dataclasses.replace(cfg, act_dtype=act, attn_chunk=chunk)
                pair[act, chunk], _ = make_prefill_step(c, use_kernel=True)(
                    params, {"tokens": tokens})
    finally:
        torch.use_deterministic_algorithms(False)
    moe_logits = pair["bfloat16", MODELS_ATTN_CHUNK].float().cpu()
    rel = _rel_err(pair["float32", MODELS_ATTN_CHUNK], pair["float32", 0])
    bf16_rel = _rel_err(pair["bfloat16", MODELS_ATTN_CHUNK],
                        pair["bfloat16", 0])
    emit("models", check="chunked_vs_dense", attn_chunk=MODELS_ATTN_CHUNK,
         act_dtype="float32", weights="bfloat16", deterministic=True,
         rel=rel, tol=CHUNKED_TOL, bf16_rel=bf16_rel)
    assert rel <= CHUNKED_TOL, ("chunked vs dense prefill", rel)
    del pair
    assert flash_attention.launches == 0, "MLA takes the plain path"
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
    del caches, logits
    srv = GroupServer(cfg, params, batch_slots=4, device="cuda")
    rng = np.random.default_rng(0)
    for rid in range(12):
        srv.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 8, dtype=np.int32), max_new=4 + rid % 5))
    t0 = time.perf_counter()
    while srv.step():
        pass
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    want = sum(4 + rid % 5 for rid in range(12))
    assert srv.members_served == want and not srv.queue \
        and all(r is None for r in srv.active), (srv.members_served, want)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    emit("models", check="full_width", arch=MODELS_ARCH, params=n_params,
         param_gib=n_params * 2 / 2**30, dtype="bfloat16", batch=B,
         seq_len=S, init_s=init_s, prefill_s=prefill_s,
         prefill_tokens_per_s=B * S / prefill_s, decode_steps=DECODE_STEPS,
         decode_ms_per_step=1e3 * decode_s / DECODE_STEPS,
         serve_requests=12, serve_slots=4, serve_steps=srv.steps_fired,
         serve_tokens=srv.members_served, serve_s=serve_s,
         peak_memory_gib=peak_gb, tokens=toks[0, :8].tolist())
    del params, srv
    torch.cuda.empty_cache()

    # the nine other architectures at their smoke configs, f32
    expected = dict.fromkeys(ROUTES, 0)
    for arch in SMOKE_ARCHS:
        a_cfg = get_config(arch, smoke=True)
        q, kv = (torch.empty((1, 1, h, a_cfg.hd), device="meta")
                 for h in (a_cfg.n_heads, a_cfg.n_kv_heads))
        f32_route = route(q, kv, kv)
        got = _arch_run(arch, seed, "cuda")
        want = cpu_runs[arch].result()
        errs = []
        for name in ("default", "cf8"):
            for x, y in zip(want[name], got[name]):
                assert x.shape == y.shape, (arch, name, x.shape, y.shape)
                errs.append(float(np.abs(x - y).max())
                            / (float(np.abs(x).max()) + 1e-6))
        full, dec = got["full"], got["cf8"][1][:, 0]
        consistency = float(np.abs(full - dec).max()) / (
            float(np.abs(full).max()) + 1e-6)
        n_glob = _n_global(a_cfg)
        emit("models", check="arch_vs_cpu", arch=arch,
             family=a_cfg.family, tensors=len(errs),
             max_rel_err_vs_cpu=max(errs), decode_vs_full_rel=consistency,
             tol=2e-4, flash_launches=got["launches"],
             flash_route=f32_route, global_layers=n_glob)
        assert max(errs) < 2e-4, (arch, "card vs CPU", max(errs))
        assert consistency < 2e-4, (arch, "decode vs full", consistency)
        # two prefills (default and capacity factor 8) through the kernel
        assert got["launches"] == 2 * n_glob, (arch, got["launches"])
        assert want["launches"] == 0, "the CPU runs the plain version"
        expected[f32_route] += got["launches"]
    expected["wgmma"] += smoke_bf16_prefill(seed)
    emit("models", check="wall", seconds=time.perf_counter() - t_phase)
    return expected, moe_logits


def smoke_bf16_prefill(seed: int) -> int:
    """qwen2-0.5b's smoke config (2 layers, 4/2 heads of 16) with bf16
    weights from ``seed`` and bf16 activations: a prefill of
    SMOKE_BF16_SHAPE on the kernel path, whose flash launches (one a layer)
    must all take the wgmma route (its D = 16 instance), against the plain
    bf16 path (last-token logits within 2e-2 of max |logit|) and no farther
    than BF16_PATH_MARGIN times the plain path from the plain f32 path.
    Returns the wgmma launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import ROUTES
    from repro_torch.models import init_params, lm_spec, prefill
    cfg = get_config(ARCH, smoke=True)
    params = init_params(lm_spec(cfg), seed, dtype=torch.bfloat16)
    B, S = SMOKE_BF16_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    before = dict(flash_attention.launches_by_route)
    lk, _ = prefill(params, cfg, tokens=toks, use_kernel=True)
    torch.cuda.synchronize()
    by_route = {r: flash_attention.launches_by_route[r] - before[r]
                for r in ROUTES}
    assert by_route == {**dict.fromkeys(ROUTES, 0), "wgmma": cfg.n_layers}, (
        "a bf16 smoke prefill at head dim 16: one wgmma launch a layer",
        by_route)
    lp, _ = prefill(params, cfg, tokens=toks, use_kernel=False)
    lf, _ = prefill(params, dataclasses.replace(cfg, act_dtype="float32"),
                    tokens=toks, use_kernel=False)
    lk, lp, lf = lk.float(), lp.float(), lf.float()
    assert lk.shape == (B, 1, cfg.padded_vocab) and bool(
        torch.isfinite(lk).all()), "smoke bf16 prefill logits"
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    f32_scale = float(lf.abs().max())
    k_rel = float((lk - lf).abs().max()) / f32_scale
    p_rel = float((lp - lf).abs().max()) / f32_scale
    emit("models", check="smoke_bf16_kernel_path", arch=cfg.name,
         head_dim=cfg.hd, batch=B, seq_len=S, launches_by_route=by_route,
         max_abs_err=err, max_abs_logit=scale, rel=err / scale, tol=2e-2,
         kernel_vs_f32_rel=k_rel, plain_vs_f32_rel=p_rel,
         rounding_margin=BF16_PATH_MARGIN)
    assert err <= 2e-2 * scale, ("smoke bf16 kernel path", err, scale)
    assert k_rel <= BF16_PATH_MARGIN * p_rel, ("smoke bf16 kernel path "
                                               "farther from f32", k_rel,
                                               p_rel)
    return by_route["wgmma"]


# the train phase: qwen2-0.5b at full width (f32 parameters and AdamW
# moments, bf16 activations, remat on), batches from make_batch (Zipf 1.0)
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SHAPE = (8, 1_024)            # batch, sequence: 8,192 tokens a step
TRAIN_STEPS = 6
FIXED_STEPS = 4
FIXED_OPT = dict(peak_lr=1e-4, warmup_steps=1, decay_steps=100)
# the reference smoke test's rate (tests/test_models_smoke.py): at full
# width, with no warmup, AdamW's first steps move every weight by ~1e-3 and
# overshoot (12.50 -> 11.07 -> 12.85 -> 12.74 on an H100 80GB HBM3, 700 W),
# so the fixed-batch check prints it only
FIXED_OPT_SMOKE = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
# the smoke-size card-vs-CPU steps (f32), their batch, and the restart run
TRAIN_CHECK_SHAPE = (2, 32)
RESTART_SHAPE = (4, 64)
# card against CPU, the bars of tests/torch_train_parity.py: loss 1e-5
# relative; grad norm 2e-4 relative; each gradient leaf within 2e-4 of its
# max |g| (its bar); parameters after the step within
# lr * eps / (2 bar * clip scale) + 1e-6 |p| where |g| > 2 bars, within
# 2 lr (an AdamW step-1 sign flip) everywhere, flips on at most 1 %
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_GRAD_BAR = 1e-5, 2e-4, 2e-4


def _train_step_run(arch: str, seed: int, device: str) -> dict:
    """One smoke-size make_train_step in f32 on ``device``, from weights of
    ``seed`` made on the CPU and one make_batch batch (both devices get the
    same numbers); its gradients from value_and_grad beside it. Returns
    numpy arrays."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import init_params, lm_spec
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              act_dtype="float32")
    params = _to(init_params(lm_spec(cfg), seed, device="cpu"), device)
    batch, _ = make_batch(DataConfig(seed=seed), cfg, *TRAIN_CHECK_SHAPE,
                          init_state(), device=device)
    _, _, grads = value_and_grad(params, cfg, batch, device=device)
    step = make_train_step(cfg, adamw.AdamWConfig(**FIXED_OPT_SMOKE),
                           device=device)
    new, _, m = step(params, adamw.init(params), batch)

    def host(tree):
        return [t.detach().to("cpu", torch.float32).numpy()
                for t in _leaves(tree)]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "old": host(params), "grads": host(grads),
            "new": host(new)}


def _train_cpu_run(arch: str, seed: int) -> dict:
    """:func:`_train_step_run` on the CPU, in a worker process."""
    return _train_step_run(arch, seed, "cpu")


def train_step_errors(got: dict, want: dict) -> dict:
    """The card's step (``got``) against the CPU's (``want``): each error
    as a fraction of its bar (see TRAIN_LOSS_TOL), and the share of
    elements that moved by more than 1e-3 lr on a small gradient."""
    lr = want["lr"]
    scale = min(1.0, 1.0 / (want["grad_norm"] + 1e-9))
    worst = dict.fromkeys(("grad", "param_firm", "param_flip"), 0.0)
    flips = total = 0
    for g_cpu, g_card, p0, p_cpu, p_card in zip(
            want["grads"], got["grads"], want["old"], want["new"],
            got["new"]):
        bar = TRAIN_GRAD_BAR * float(np.abs(g_cpu).max()) + 1e-12
        worst["grad"] = max(worst["grad"],
                            float(np.abs(g_card - g_cpu).max()) / bar)
        firm = np.abs(g_cpu) > 2 * bar
        tol = 1e-6 * np.abs(p0) + 1e-7
        diff = np.abs(p_card - p_cpu)
        if firm.any():
            firm_tol = tol + lr * 1e-8 / (2 * bar * scale)
            worst["param_firm"] = max(worst["param_firm"], float(
                (diff[firm] / firm_tol[firm]).max()))
        worst["param_flip"] = max(worst["param_flip"], float(
            (diff / (2 * lr * 1.001 + tol)).max()))
        flips += int(((diff > lr * 1e-3 + tol) & ~firm).sum())
        total += diff.size
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"])
            / TRAIN_LOSS_TOL,
            "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"])
            / want["grad_norm"] / TRAIN_GNORM_TOL,
            **worst, "flip_share": flips / total}


def model_flops_per_token(cfg, seq: int) -> float:
    """Training FLOPs a token (forward and backward, no recompute): 6 per
    parameter of every matmul (the head included, the embedding gather
    not) and 12 L H D S for attention's two products over the full S x S
    scores, which the plain path computes."""
    from repro_torch.models import lm_spec, tree_leaves
    spec = lm_spec(cfg)
    n = sum(math.prod(s.shape) for s in tree_leaves(spec["blocks"])
            if len(s.shape) == 2) + math.prod(spec["head"]["w"].shape)
    return 6.0 * n + 12.0 * cfg.n_layers * cfg.n_heads * cfg.hd * seq


def phase_train(seed: int, cpu_runs: dict, rates) -> list:
    """The training half: full-width qwen2-0.5b through train()'s own loop,
    a fixed batch whose loss must fall, smoke-size steps on the card
    against the CPU (``cpu_runs``: futures by architecture), and a restart
    that must repeat the uninterrupted run's losses bit for bit. Returns
    the full-width run's losses and the smoke-size card steps' losses by
    architecture."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import count_params, init_params, lm_spec
    from repro_torch.optim import adamw
    from repro_torch.configs import ARCHS
    assert set(cpu_runs) == {a for a in ARCHS
                             if get_config(a).embed_inputs}, sorted(cpu_runs)
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN_SHAPE
    emit("train", check="cut", arch=TRAIN_ARCH, batch=B, seq_len=S,
         steps=TRAIN_STEPS, remat=cfg.remat, act_dtype=cfg.act_dtype,
         note="train_4k's 4,096 x 256 cut to 1,024 x 8 for the time limit; "
              "f32 parameters and moments; no checkpoint at full width")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    records = []
    losses = train(TRAIN_ARCH, False, TRAIN_STEPS, B, S, None,
                   log_every=TRAIN_STEPS, device="cuda",
                   on_step=records.append)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    flops = model_flops_per_token(cfg, S) * B * S
    for r in records:
        emit("train", check="step", step=r["step"], loss=r["loss"],
             grad_norm=r["grad_norm"], lr=r["lr"], ms=1e3 * r["seconds"],
             tokens_per_s=B * S / r["seconds"],
             model_flop_share=flops / r["seconds"] / rates[2])
    assert len(losses) == TRAIN_STEPS and all(
        math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
        for r in records), records
    steady = [r["seconds"] for r in records[1:]]
    step_s = sum(steady) / len(steady)
    emit("train", check="full_width", arch=TRAIN_ARCH,
         params=count_params(lm_spec(cfg)), batch=B, seq_len=S,
         first_step_ms=1e3 * records[0]["seconds"], step_ms=1e3 * step_s,
         step_ms_each=[1e3 * x for x in steady],
         tokens_per_s=B * S / step_s, model_tflop_per_step=flops / 1e12,
         model_flop_share=flops / step_s / rates[2],
         peak_memory_gib=peak_gb,
         note="steps 2-6 (the first, a cold start, is reported apart); "
              "share of the dense bf16 rate")

    # one fixed batch at full width, from the same weights at two peak
    # rates: the loss must fall at FIXED_OPT's; at the reference smoke
    # test's 1e-3 (FIXED_OPT_SMOKE) it is printed only
    params0 = init_params(lm_spec(cfg), seed)
    batch, _ = make_batch(DataConfig(seed=seed), cfg, B, S, init_state(),
                          device="cuda")
    for opt_kw, checked in ((FIXED_OPT_SMOKE, False), (FIXED_OPT, True)):
        params, opt = params0, adamw.init(params0)
        step = make_train_step(cfg, adamw.AdamWConfig(**opt_kw))
        fixed = []
        for _ in range(FIXED_STEPS):
            params, opt, m = step(params, opt, batch)
            fixed.append(float(m["loss"]))
        emit("train", check="fixed_batch", losses=fixed, asserted=checked,
             **opt_kw)
        del params, opt
        assert not checked or fixed[-1] < fixed[0], \
            ("fixed-batch loss must fall from step 1 to the last", fixed)
    del params0, batch
    torch.cuda.empty_cache()

    # smoke-size steps of every token-input architecture, card against CPU
    card_losses = {}
    for arch, fut in cpu_runs.items():
        got = _train_step_run(arch, seed, "cuda")
        card_losses[arch] = got["loss"]
        err = train_step_errors(got, fut.result())
        emit("train", check="card_vs_cpu", arch=arch, act_dtype="float32",
             **err, note="errors as fractions of their bars")
        assert max(v for k, v in err.items() if k != "flip_share") <= 1.0 \
            and err["flip_share"] <= 0.01, (arch, err)

    # restart at smoke size: the resumed steps repeat the uninterrupted
    # run's losses bit for bit (deterministic algorithms: the embedding and
    # gather backwards sum with atomics otherwise)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    kw = dict(arch=TRAIN_ARCH, smoke=True, batch=RESTART_SHAPE[0],
              seq=RESTART_SHAPE[1], ckpt_every=2, log_every=100,
              device="cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            full = train(steps=4, ckpt_dir=f"{d}/a", **kw)
            first = train(steps=2, ckpt_dir=f"{d}/b", **kw)
            rest = train(steps=4, ckpt_dir=f"{d}/b", **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    emit("train", check="restart", uninterrupted=full, first=first,
         resumed=rest)
    assert first == full[:2] and rest == full[2:], (full, first, rest)
    emit("train", check="wall", seconds=time.perf_counter() - t_phase)
    return losses, card_losses


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


def flash_bound(exp2: int, tensor_flops: float, nbytes: float, peak: float,
                bw: float, unit: str) -> tuple[float, str, dict]:
    """The least time (ms) a flash call could take on this card: the
    largest of its bytes over the memory rate ``bw``, its tensor-core work
    over ``peak`` (named ``unit``) and its ``exp2`` exponentials, one a
    visible (query, key) pair, on the MUFU units (16 a clock an SM) at the
    card's maximum SM clock. Returns (ms, "bytes" or "operations", each
    bound in ms by name)."""
    clock = float(gpu_query("clocks.max.sm")["clocks.max.sm"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bounds = {"bytes": nbytes / bw * 1e3, unit: tensor_flops / peak * 1e3,
              "exp2": exp2 / (MUFU_EXP2_PER_CLOCK * n_sm * clock * 1e6)
              * 1e3}
    worst = max(bounds, key=bounds.get)
    return bounds[worst], "bytes" if worst == "bytes" else "operations", \
        bounds


GEMMA3_ARCH = "gemma3-12b"


def sdpa_library_run(q, k, v, gqa: bool = True):
    """``fn() -> (B, H, S, D)``: one scaled_dot_product_attention call on
    (B, H, S, D) copies of q, k and v (causal, GQA), on a fused backend
    (flash, memory-efficient or cuDNN), and the call's description. With
    ``gqa=False`` the copies of k and v repeat each kv head H/K times (made
    here, outside the call), for backends without ``enable_gqa`` (f32 runs
    only on the memory-efficient one)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not gqa:
        G = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def run():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=gqa)
    return run, (f"scaled_dot_product_attention(is_causal=True, "
                 f"enable_gqa={gqa}), fused backends"
                 + ("" if gqa else ", kv heads repeated beforehand"))


def flash_gemma3(gen, rates, ptxas: list, launches: int) -> dict:
    """gemma3-12b's global-layer attention at a prefill of 8,192 tokens
    (B=1, H=16, K=8, D=240, bf16, causal) on the wgmma kernel's D = 240
    instance: against the plain version (ref.bf16_errors with the split's
    bound), then kernel and SDPA timed in turns, the plain version once.
    ``launches`` is the wgmma launches of the cut-depth gemma3 path
    (:func:`gemma3_path`); ``launches_per_prefill`` the full model's global
    layers, one launch each."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        attention_bf16p_model, attention_ref, flash_attention, kernel_sm90,
        route)
    from repro_torch.kernels.flash_attention.ref import bf16_errors
    g3 = get_config(GEMMA3_ARCH)
    B, S, H, K, D = 1, 8_192, g3.n_heads, g3.n_kv_heads, g3.hd
    q = _rand(gen, (B, S, H, D), torch.bfloat16)
    k, v = (_rand(gen, (B, S, K, D), torch.bfloat16) for _ in range(2))
    assert route(q, k, v) == "wgmma"
    before = flash_attention.launches_by_route["wgmma"]
    got = flash_attention(q, k, v)
    assert flash_attention.launches_by_route["wgmma"] == before + 1
    want = bf16_chunked(q, k, v, attention_ref)
    e = bf16_errors(got, want, bf16_chunked(q, k, v, attention_bf16p_model),
                    v)
    emit("flash", check="vs_plain_gemma3_shape", shape=[B, S, S, H, K, D],
         dtype="torch.bfloat16", kernel_route="wgmma", **e)
    assert e["ok"], ("wgmma kernel vs plain at gemma3's shape", e)
    del got, want
    library_run, library_call = sdpa_library_run(q, k, v)

    def kernel_run():
        return flash_attention(q, k, v)
    turns = [(fn, cuda_ms(fn, reps=10)) for fn in
             (kernel_run, library_run, library_run, kernel_run)]
    card = gpu_query("clocks.sm", "clocks.max.sm", "power.draw",
                     "power.limit")
    kernel_runs = [t for fn, t in turns if fn is kernel_run]
    library_runs = [t for fn, t in turns if fn is library_run]
    plain_ms = cuda_ms(lambda: bf16_chunked(q, k, v, attention_ref), reps=2)
    bw, _, bf16_peak, _ = rates
    pairs = B * S * (S + 1) // 2
    flops = 4 * H * D * pairs
    nbytes = (B * S * H * D + 2 * B * S * K * D) * 2 + B * S * H * D * 4
    bound_ms, bound_by, bounds = flash_bound(H * pairs, flops, nbytes,
                                             bf16_peak, bw, "bf16")
    kernel_ms = sum(kernel_runs) / 2
    inst = kernel_sm90.instance_name(D)
    regs = [u for u in ptxas if inst in u["kernel"]]
    assert len(regs) == 1, ("ptxas report of the D = 240 instance", inst)
    emit("flash", check="ptxas_d240", **regs[0])
    assert regs[0]["spill_store_bytes"] == 0, ("D = 240 spills", regs[0])
    row = {"name": "flash_attention", "route": "cuda",
           "kernel_route": "wgmma", "arch": GEMMA3_ARCH,
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention_sm90.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
           "launches": launches, "launches_per_prefill": _n_global(g3),
           "max_abs_err": e["max_abs"], "rms_err": e["rms"],
           "model_max_abs_err": e["model_max_abs"],
           "split_p_bound": e["split_p_bound"],
           "ms": kernel_ms, "kernel_ms_runs": kernel_runs,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bounds_ms": bounds, "library_ms": sum(library_runs) / 2,
           "library_ms_runs": library_runs, "library_call": library_call,
           "tflops": flops / (kernel_ms * 1e-3) / 1e12,
           "split_p_bound_ms": 1.5 * flops / bf16_peak * 1e3,
           "ptxas": regs[0], "card_after_timing": card,
           "shape": {"B": B, "S": S, "H": H, "K": K, "D": D,
                     "dtype": "bfloat16", "flops": flops, "bytes": nbytes,
                     "exp2": H * pairs}}
    emit("flash", check="gemma3_shape", **row)
    return row


def flash_f32_route(q, k, v, ptxas: list, rates, launches: int) -> dict:
    """The f32 route at the main path's shape (qwen2-0.5b's heads, B=1,
    S=32,768, causal; ``q``, ``k`` and ``v`` f32): the tf32x3 kernel
    against the plain version (max abs error within SAME_INPUTS_TOL, and
    its ratio to the reference's 2e-6 + 2e-6 |want|), then timed in turns
    beside SDPA in f32 (tf32x3, SDPA, SDPA, tf32x3), the plain version
    once; the bound (the largest of the bytes, three TF32 passes at the
    dense TF32 peak and the exp2) and the CUDA-core f32 bound; ptxas's
    registers and spills of the D = 64 instance (no spill allowed).
    ``launches`` is the models phase's tf32x3 launches. Returns the
    ``kernels`` summary's row."""
    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention, kernel_tf32, route)
    from repro_torch.kernels.flash_attention.ref import F32_TOL
    B, S, H, D = q.shape
    K = k.shape[2]
    assert route(q, k, v) == "tf32x3"
    before = flash_attention.launches_by_route["tf32x3"]
    got = flash_attention(q, k, v)
    assert flash_attention.launches_by_route["tf32x3"] == before + 1
    want = bf16_chunked(q, k, v, attention_ref)
    err = float((got - want).abs().max())
    bar = float(((got - want).abs() / (F32_TOL + F32_TOL * want.abs()))
                .max())
    del got, want
    emit("flash", check="f32_vs_plain_main_path_shape",
         shape=[B, S, S, H, K, D], dtype="torch.float32",
         kernel_route="tf32x3", max_abs_err=err, f32_bar_ratio=bar,
         tol=SAME_INPUTS_TOL)
    assert err <= SAME_INPUTS_TOL, ("tf32x3 kernel vs plain at the main "
                                    "path's shape", err)
    library_run, library_call = sdpa_library_run(q, k, v, gqa=False)

    def kernel_run():
        return flash_attention(q, k, v)
    turns = [(fn, cuda_ms(fn, reps=r)) for fn, r in
             ((kernel_run, 5), (library_run, 3), (library_run, 3),
              (kernel_run, 5))]
    card = gpu_query("name", "clocks.sm", "clocks.max.sm", "power.draw",
                     "power.limit")
    kernel_runs, library_runs = ([t for f, t in turns if f is fn]
                                 for fn in (kernel_run, library_run))
    library_diff = float((library_run().transpose(1, 2)
                          - kernel_run()).abs().max())
    plain_ms = cuda_ms(lambda: bf16_chunked(q, k, v, attention_ref), reps=1)
    bw, f32_peak, _, tf32_peak = rates
    pairs = H * B * S * (S + 1) // 2
    flops = 4 * D * pairs
    nbytes = (B * S * H * D + 2 * B * S * K * D) * 4 + B * S * H * D * 4
    bound_ms, bound_by, bounds = flash_bound(pairs, 3 * flops, nbytes,
                                             tf32_peak, bw, "tf32x3")
    kernel_ms = sum(kernel_runs) / 2
    inst = kernel_tf32.instance_name(D)
    regs = [u for u in ptxas if inst in u["kernel"]]
    assert len(regs) == 1, ("ptxas report of the tf32x3 D = 64 instance",
                            inst)
    emit("flash", check="ptxas_tf32_d64", **regs[0])
    assert regs[0]["spill_store_bytes"] == 0, ("tf32x3 D = 64 spills",
                                               regs[0])
    row = {"name": "flash_attention_tf32x3", "route": "cuda",
           "kernel_route": "tf32x3",
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention_tf32.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
           "launches": launches,
           "launches_on": "the models phase's f32 prefills",
           "max_abs_err": err, "f32_bar_ratio": bar, "ms": kernel_ms,
           "kernel_ms_runs": kernel_runs, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bounds_ms": bounds,
           "tf32x3_bound_ms": bounds["tf32x3"],
           "f32_cores_bound_ms": flops / f32_peak * 1e3,
           "library_ms": sum(library_runs) / 2,
           "library_ms_runs": library_runs,
           "library_call": library_call + " on f32 inputs",
           "library_vs_kernel_max_abs": library_diff,
           "tflops": flops / (kernel_ms * 1e-3) / 1e12,
           "ptxas": regs[0], "card_after_timing": card,
           "shape": {"B": B, "S": S, "H": H, "K": K, "D": D,
                     "dtype": "float32", "flops": flops,
                     "tf32_flops": 3 * flops, "bytes": nbytes,
                     "exp2": pairs}}
    emit("flash", check="f32_route", **row)
    return row


# the routes at the other head dims, at gemma3-12b's global-layer shape
# (B=1, S=8,192, H=16, K=8): f32 on tf32x3 at D = 240, 16, 32 and 128; bf16
# on wgmma at D = 16 and 32 (its instances bound by the exponentials)
OTHER_DIMS = ((torch.float32, 240), (torch.float32, 16), (torch.float32, 32),
              (torch.float32, 128), (torch.bfloat16, 16),
              (torch.bfloat16, 32))


def flash_other_dims(gen, rates, ptxas: list) -> list:
    """The flash routes at the head dims the main path's shape does not
    take (``OTHER_DIMS``): f32 (tf32x3) checked against the plain version
    (SAME_INPUTS_TOL), bf16 (wgmma) held to ref.bf16_errors with the split's
    bound; then kernel and SDPA in the same dtype timed in turns (kernel,
    SDPA, SDPA, kernel), the plain version once, with the bound (the
    largest of the bytes, the dtype's tensor work, 3xTF32 on tf32x3 and
    bf16 on wgmma, and the exp2: :func:`flash_bound`) and the CUDA-core f32
    bound; ptxas's report of the tf32x3 D = 240 and the wgmma D = 16 and 32
    instances (no spill allowed). Returns the rows."""
    from repro_torch.kernels.flash_attention import (
        attention_bf16p_model, attention_ref, flash_attention, kernel_sm90,
        kernel_tf32, route)
    from repro_torch.kernels.flash_attention.ref import bf16_errors
    B, S, H, K = 1, 8_192, 16, 8
    bw, f32_peak, bf16_peak, tf32_peak = rates
    rows = []
    for dt, D in OTHER_DIMS:
        q = _rand(gen, (B, S, H, D), dt)
        k, v = (_rand(gen, (B, S, K, D), dt) for _ in range(2))
        rt = route(q, k, v)
        assert rt == ("tf32x3" if dt == torch.float32 else "wgmma"), (dt, D)
        want = bf16_chunked(q, k, v, attention_ref)
        got = flash_attention(q, k, v)
        row = {"kernel_route": rt, "dtype": str(dt), "D": D,
               "shape": [B, S, S, H, K, D]}
        if rt == "wgmma":
            e = bf16_errors(got, want,
                            bf16_chunked(q, k, v, attention_bf16p_model), v)
            row.update(max_abs_err=e["max_abs"], rms_err=e["rms"],
                       model_max_abs_err=e["model_max_abs"],
                       model_rms_err=e["model_rms"],
                       split_p_bound=e["split_p_bound"], bar_ok=e["ok"])
            assert e["ok"], ("wgmma kernel vs plain", D, e)
        else:
            err = float((got - want).abs().max())
            row.update(max_abs_err=err, tol=SAME_INPUTS_TOL)
            assert err <= SAME_INPUTS_TOL, ("flash route", dt, D, rt, err)
        del got, want
        library_run, library_call = sdpa_library_run(
            q, k, v, gqa=dt != torch.float32)

        def kernel_run():
            return flash_attention(q, k, v)
        turns = [(fn, cuda_ms(fn, reps=5)) for fn in
                 (kernel_run, library_run, library_run, kernel_run)]
        kernel_runs, library_runs = ([t for f, t in turns if f is fn]
                                     for fn in (kernel_run, library_run))
        plain_ms = cuda_ms(lambda: bf16_chunked(q, k, v, attention_ref),
                           reps=2)
        pairs = H * B * S * (S + 1) // 2
        flops = 4 * D * pairs
        nbytes = ((B * S * H * D + 2 * B * S * K * D) * q.element_size()
                  + B * S * H * D * 4)
        bound_ms, bound_by, bounds = (
            flash_bound(pairs, 3 * flops, nbytes, tf32_peak, bw, "tf32x3")
            if rt == "tf32x3" else
            flash_bound(pairs, flops, nbytes, bf16_peak, bw, "bf16"))
        bounds["f32_cores"] = flops / f32_peak * 1e3
        if rt == "wgmma" or D == 240:
            inst = (kernel_sm90 if rt == "wgmma" else kernel_tf32
                    ).instance_name(D)
            regs = [u for u in ptxas if inst in u["kernel"]]
            assert len(regs) == 1, ("ptxas report", rt, D, inst)
            emit("flash", check=f"ptxas_{rt}_d{D}", **regs[0])
            assert regs[0]["spill_store_bytes"] == 0, (rt, D, "spills",
                                                       regs[0])
            row["ptxas"] = regs[0]
        row.update({"ms": sum(kernel_runs) / len(kernel_runs),
                    "kernel_ms_runs": kernel_runs, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bounds_ms": bounds,
                    "library_ms": sum(library_runs) / 2,
                    "library_ms_runs": library_runs,
                    "library_call": library_call + f" on {dt} inputs",
                    "card": gpu_query("name", "clocks.sm", "clocks.max.sm",
                                      "power.limit")})
        emit("flash", check="other_dims", **row)
        rows.append(row)
        del q, k, v
    return rows


# gemma3-12b at full width, its depth cut from 48 layers (8 units of 5 local
# + 1 global) to one unit, and its prompt to one of 4,096 tokens
GEMMA3_SEQ = 4_096


def gemma3_path(seed: int) -> tuple[dict, dict]:
    """gemma3-12b's serving path at full width (d 3840, 16/8 heads of 240,
    d_ff 15,360, vocab 262,144) with bf16 weights from ``seed``, cut to one
    unit of its layout (5 local + 1 global): one bf16 prefill of 4,096
    tokens on the kernel path (the global layer's attention on the wgmma
    kernel, one launch: the counts are zeroed right before and read right
    after), on the plain path, and on the kernel path with f32 activations
    (the tf32x3 kernel's D = 240 instance, one launch, counted the same
    way), held to qwen2's ``path_bf16`` bars. Returns the launches by route
    of the bf16 and of the f32 kernel-path prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import ROUTES
    from repro_torch.models import count_params, init_params, lm_spec, prefill
    g3 = get_config(GEMMA3_ARCH)
    (unit, reps), = g3.layout
    cfg = dataclasses.replace(g3, layout=((unit, 1),))
    B, S = 1, GEMMA3_SEQ
    emit("flash", check="gemma3_cut", arch=GEMMA3_ARCH,
         layers=len(unit), full_layers=len(unit) * reps,
         params=count_params(lm_spec(cfg)), batch=B, seq_len=S,
         note=f"depth cut from {len(unit) * reps} layers to one unit of "
              f"its layout ({len(unit) - 1} local + 1 global); weights bf16")
    params = init_params(lm_spec(cfg), seed, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, _ = prefill(params, cfg, tokens=toks, use_kernel=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_route = dict(flash_attention.launches_by_route)
    emit("gemma3_path", launches={"flash_attention": flash_attention.launches,
                                  "flash_attention_by_route": by_route})
    assert by_route == {**dict.fromkeys(ROUTES, 0), "wgmma": 1}, (
        "a bf16 gemma3 prefill: one wgmma launch (its global layer)",
        by_route)
    lp, _ = prefill(params, cfg, tokens=toks, use_kernel=False)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    torch.cuda.synchronize()
    lf, _ = prefill(params, cfg32, tokens=toks, use_kernel=True)
    torch.cuda.synchronize()
    by_route_f32 = dict(flash_attention.launches_by_route)
    emit("gemma3_path", f32_launches_by_route=by_route_f32)
    assert by_route_f32 == {**dict.fromkeys(ROUTES, 0), "tf32x3": 1}, (
        "an f32 gemma3 prefill: one tf32x3 launch (its global layer, D = "
        "240), none on wgmma", by_route_f32)
    lk, lp, lf = lk.float(), lp.float(), lf.float()
    assert lk.shape == (B, 1, cfg.padded_vocab) and bool(
        torch.isfinite(lk).all()), "gemma3 prefill logits"
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    f32_scale = float(lf.abs().max())
    k_rel = float((lk - lf).abs().max()) / f32_scale
    p_rel = float((lp - lf).abs().max()) / f32_scale
    emit("flash", check="gemma3_path_bf16", arch=GEMMA3_ARCH, batch=B,
         seq_len=S, max_abs_err=err, max_abs_logit=scale, rel=err / scale,
         tol=2e-2, kernel_vs_f32_rel=k_rel, plain_vs_f32_rel=p_rel,
         rounding_margin=BF16_PATH_MARGIN, prefill_s=prefill_s,
         prefill_tokens_per_s=B * S / prefill_s,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    assert err <= 2e-2 * scale, ("gemma3 bf16 kernel path", err, scale)
    assert k_rel <= BF16_PATH_MARGIN * p_rel, ("gemma3 bf16 kernel path "
                                               "farther from f32", k_rel,
                                               p_rel)
    del params
    torch.cuda.empty_cache()
    return by_route, by_route_f32


def phase_flash(cfg, params, seed: int, launches: int, by_route: dict,
                tf32_launches: int, small_launches: int, ptxas: list,
                rates) -> tuple[dict, dict]:
    """The flash kernels' checks and times; returns the bf16 (wgmma) row and
    the f32 (tf32x3) row of the ``kernels`` summary. ``launches`` and
    ``by_route`` are the model phase's (bf16 prefill), ``tf32_launches``
    the models phase's tf32x3 launches (the smoke architectures' f32
    prefills), ``small_launches`` its wgmma ones (qwen2's bf16 smoke
    prefill at head dim 16)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, attention_ref, attention_bf16p_model, route)
    from repro_torch.kernels.flash_attention import kernel_sm90
    from repro_torch.kernels.flash_attention.ref import F32_TOL, bf16_errors
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
             (2, 300, 300, 14, 2, 64, 1, extra),    # (B, H, S, D) data
             # the models phase's bf16 qwen2 smoke prefill at D = 16:
             # ragged 128-key tiles, a full and a partial 256-row CTA
             (2, 333, 333, 4, 2, 16, 0, extra)]

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
            assert path == ("tf32x3" if dt == torch.float32 else "wgmma"), (
                D, path)
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
                # f32 (tf32x3): the reference's 2e-6
                torch.testing.assert_close(got, want, rtol=F32_TOL,
                                           atol=F32_TOL)
                emit("flash", check="vs_plain", **row, tol=F32_TOL,
                     max_abs_err=float((got - want).abs().max()))

    # a negative scale: the wgmma kernel on the negated keys
    # (ops.wgmma_operands), at the bf16 smoke prefill's shape and at D = 64
    for B, Sq, H, K, D in ((2, 333, 4, 2, 16), (1, 2048, 14, 2, 64)):
        q = _rand(extra, (B, Sq, H, D), torch.bfloat16)
        k, v = (_rand(extra, (B, Sq, K, D), torch.bfloat16)
                for _ in range(2))
        s = -D ** -0.5
        before = flash_attention.launches_by_route["wgmma"]
        got = flash_attention(q, k, v, causal=True, scale=s)
        assert flash_attention.launches_by_route["wgmma"] == before + 1
        e = bf16_errors(got, attention_ref(q, k, v, causal=True, scale=s),
                        attention_bf16p_model(q, k, v, causal=True,
                                              scale=s), v)
        emit("flash", check="vs_plain_negative_scale",
             shape=[B, Sq, Sq, H, K, D], scale=s, dtype="torch.bfloat16",
             kernel_route="wgmma", **e)
        assert e["ok"], ("wgmma kernel vs plain, negative scale", D, e)

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

    library_run, library_call = sdpa_library_run(q, k, v)

    def kernel_run():
        return flash_attention(q, k, v)
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
    bw, _, bf16_peak, _ = rates
    pairs = B * S * (S + 1) // 2              # (query, key) pairs attended
    flops = 4 * H * D * pairs                  # QK^T and PV, 2 per FMA
    nbytes = (B * S * H * D + 2 * B * S * K * D) * 2 + B * S * H * D * 4
    bound_ms, bound_by, bounds = flash_bound(H * pairs, flops, nbytes,
                                             bf16_peak, bw, "bf16")
    clock = float(card["clocks.max.sm"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
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
           "bound_ms": bound_ms, "bound_by": bound_by, "bounds_ms": bounds,
           "library_ms": library_ms, "library_ms_runs": library_runs,
           "library_call": library_call,
           "tflops": flops / (kernel_ms * 1e-3) / 1e12,
           "exp_bound_ms": bounds["exp2"], "sm_clock_max_mhz": clock,
           "sms": n_sm, "card_after_timing": card,
           "ptxas": regs[0] if regs else None,
           "shape": {"B": B, "S": S, "H": H, "K": K, "D": D,
                     "dtype": "bfloat16", "flops": flops, "bytes": nbytes,
                     "exp2": pairs * H}}
    emit("flash", check="main_path_shape", **row)
    tf32_row = flash_f32_route(q.float(), k.float(), v.float(), ptxas, rates,
                               tf32_launches)
    other = flash_other_dims(gen, rates, ptxas)
    for r in other:
        if r["kernel_route"] == "wgmma":    # the models phase's smoke prefill
            r["launches"] = small_launches if r["D"] == 16 else 0
            r["launches_on"] = ("qwen2-0.5b smoke's bf16 prefill (models "
                                "phase)")
    tf32_row["other_dims"] = [r for r in other if r["kernel_route"] ==
                              "tf32x3"]
    row["other_dims"] = [r for r in other if r["kernel_route"] == "wgmma"]
    gemma3_bf16, gemma3_f32 = gemma3_path(seed)
    tf32_row["gemma3_f32_prefill_launches_by_route"] = gemma3_f32
    row["gemma3_d240"] = flash_gemma3(gen, rates, ptxas,
                                      gemma3_bf16["wgmma"])
    return row, tf32_row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--horizon", type=int, default=REF_ENGINE_HORIZON,
                    help="engine-phase horizon in ticks (0.1 us each); cut "
                         "from 200,000 so the eager engine (~10 ms per "
                         "iteration on an H100 host) and the sweep phases "
                         "fit the time limit")
    ap.add_argument("--sweep-horizon", type=int, default=FIG8_HORIZON,
                    help="horizon of the sweep phase's Figure 8 grid, in "
                         "ticks (cut from fig08's quick 200,000)")
    ap.add_argument("--fig15-horizon", type=int, default=0,
                    help="run only fig15's skew_ramp scenario at this "
                         "horizon (ticks) on the card, then exit")
    ap.add_argument("--ref-full", action="store_true",
                    help="run only the reference fixture's uncut points "
                         "(the CPU tests' grids at the reference tests' "
                         "horizons) on the card, check them, then exit")
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
    sys.path.insert(0, str(ROOT / "tools"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.grouped_scatter import kernel, segment_sums
    from repro_torch.kernels.flash_attention import kernel_sm90, kernel_tf32
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
    if args.fig15_horizon:
        phase_fig15(args.fig15_horizon)
        emit("done", wall_s=time.perf_counter() - t_start)
        return 0
    ref = load_ref()
    if args.ref_full:
        phase_ref_full(ref)
        emit("done", wall_s=time.perf_counter() - t_start)
        return 0
    ptxas = phase_build([kernel, kernel_sm90, kernel_tf32])
    lap("gpu+build")

    # the main path: engine at full width, then the group-locking apply;
    # kernel launch counts are zeroed right before and read right after
    zero_counts()
    single, engine_ms, summaries = phase_engine(args.horizon)
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
    cfg, params, prefill_logits = phase_model(args.seed)
    torch.cuda.synchronize()
    flash_launches = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    emit("model_path", launches={"segment_sums": segment_sums.launches,
                                 "flash_attention": flash_launches,
                                 "flash_attention_by_route": by_route})
    assert flash_launches == cfg.n_layers, \
        ("flash launches per prefill", flash_launches, cfg.n_layers)
    assert by_route == {**dict.fromkeys(ROUTES, 0), "wgmma": cfg.n_layers}, \
        ("a bf16 prefill's flash launches all take the wgmma route", by_route)
    lap("model")

    # every other family's serving path, counted the same way; the smoke
    # architectures' CPU halves run in worker processes meanwhile
    with worker_pool(CHECK_WORKERS) as pool:
        cpu_runs = {a: pool.submit(_arch_cpu_run, a, args.seed)
                    for a in SMOKE_ARCHS}
        zero_counts()
        models_launches, moe_logits = phase_models(args.seed, cpu_runs)
        torch.cuda.synchronize()
    emit("models_path", launches={
        "segment_sums": segment_sums.launches,
        "flash_attention": flash_attention.launches,
        "flash_attention_by_route": dict(flash_attention.launches_by_route)})
    assert flash_attention.launches == sum(models_launches.values()) > 0, \
        ("flash launches of the models phase", flash_attention.launches,
         models_launches)
    assert flash_attention.launches_by_route == models_launches, \
        ("the smoke architectures run in f32: each launch on the route the "
         "table gives f32 at its head dim; qwen2's bf16 smoke prefill on "
         "wgmma", flash_attention.launches_by_route, models_launches)
    lap("models")

    # the training half, counted the same way (no kernel lies on it: the
    # flash kernels have no backward pass); the smoke-size steps' CPU halves
    # run in worker processes meanwhile
    with worker_pool(CHECK_WORKERS) as pool:
        cpu_runs = {a: pool.submit(_train_cpu_run, a, args.seed)
                    for a in TRAIN_CHECK_ARCHS}
        zero_counts()
        train_losses, smoke_losses = phase_train(args.seed, cpu_runs,
                                                 card_rates(name))
        torch.cuda.synchronize()
    emit("train_path", launches={"segment_sums": segment_sums.launches,
                                 "flash_attention": flash_attention.launches})
    assert segment_sums.launches == flash_attention.launches == 0, \
        "the train path takes the plain attention path"
    lap("train")

    # the engine held to the reference's answers; engine_invariants' two
    # packs run on the card in worker processes meanwhile
    with worker_pool(2) as pool:
        packs = {c: pool.submit(_invariant_pack, c)
                 for c in ("drain", "oracle")}
        phase_engine_vs_ref(ref, summaries if args.horizon
                            == ref["engine_full"]["horizon"] else None)
        lap("engine_vs_ref")
        phase_engine_mid_vs_ref(ref)
        lap("engine_mid_vs_ref")
        phase_engine_invariants(packs)
        lap("engine_invariants")

    # the batched engine and the sweep: no TPU kernel lies on this path
    # (the engine step is plain torch), so its counts stay at 0
    zero_counts()
    phase_batch_width()
    lap("batch_width")
    phase_sweep(ref, args.sweep_horizon)
    lap("sweep")
    sweep_pts, sweep_res = phase_sweep_vs_single()
    lap("sweep_vs_single")
    emit("sweep_path", launches={"segment_sums": segment_sums.launches,
                                 "flash_attention": flash_attention.launches})

    # execution across devices: the lane split (no kernel on it), the
    # FSDP+TP steps (plain attention), the tensor-parallel prefill (the
    # flash kernel on the rank's local heads, once a layer) and the MoE
    # layer on the mesh (MLA's plain path: no kernel)
    zero_counts()
    phase_shards(sweep_pts, sweep_res, train_losses, cfg, params,
                 prefill_logits, {"logits": moe_logits,
                                  "train_losses": smoke_losses}, args.seed)
    torch.cuda.synchronize()
    shard_routes = dict(flash_attention.launches_by_route)
    emit("shards_path", launches={
        "segment_sums": segment_sums.launches,
        "flash_attention": flash_attention.launches,
        "flash_attention_by_route": shard_routes}, ranks=1)
    assert flash_attention.launches == cfg.n_layers and \
        shard_routes["wgmma"] == cfg.n_layers and \
        segment_sums.launches == 0, \
        ("one wgmma flash launch a layer of the tensor-parallel prefill",
         flash_attention.launches, shard_routes)
    lap("shards")

    # the governor and the serving layer ride the segmented engine: no TPU
    # kernel lies on these paths either, so their counts stay at 0
    zero_counts()
    phase_governed(single, args.horizon)
    lap("governed")
    emit("governed_path", launches={
        "segment_sums": segment_sums.launches,
        "flash_attention": flash_attention.launches})
    zero_counts()
    phase_serving(single, args.horizon)
    lap("serving")
    phase_adaptive_serving_vs_ref(ref)
    lap("adaptive_serving_vs_ref")
    phase_fig_grids(FIG17_HORIZON)
    lap("fig_grids")
    emit("serving_path", launches={
        "segment_sums": segment_sums.launches,
        "flash_attention": flash_attention.launches})

    # the observability layer and the certifier ride the engine step: no TPU
    # kernel lies on this path either, so the counts stay at 0
    zero_counts()
    phase_trace(single, engine_ms, args.horizon)
    lap("trace")
    phase_trace_vs_cpu()
    lap("trace_vs_cpu")
    phase_prof(args.horizon)
    lap("prof")
    emit("obs_path", launches={"segment_sums": segment_sums.launches,
                               "flash_attention": flash_attention.launches})
    row = phase_kernels(inputs, launches, card_rates(name))
    lap("kernels")
    flash_row, tf32_row = phase_flash(cfg, params, args.seed, flash_launches,
                                      by_route, models_launches["tf32x3"],
                                      models_launches["wgmma"], ptxas,
                                      card_rates(name))
    lap("flash")
    emit("done", wall_s=time.perf_counter() - t_start, phase_wall_s=walls)
    print(json.dumps({"kernels": [row, flash_row, tf32_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
