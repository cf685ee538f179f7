"""Port checks that need the NVIDIA card (marker ``cuda``): the CUDA kernels
against their plain versions, the engine on the card against its CPU run
(single lanes, packs of lanes and segmented packs), a compacted sweep
against the sort-then-cut one, a governed pack and an open-load serving
pack against their CPU runs, traced runs against their CPU runs (and the
tracer's record adding no host sync), the step profiler on the card, the
qwen2 serving path through the flash kernel against the plain path,
gemma3's head dim 240 on both flash kernels (and the wgmma kernel writing
nothing past its output), the f32 3xTF32 kernel (its prep layout bit for
bit, its model, strided inputs, nothing written past its output), and
every other architecture's
prefill and decode (and MoE's capacity drops) on the card against the
CPU, and the training half (the kernel wrappers refusing gradients,
batches, train steps and the grouped embedding gradient against the CPU, a
bit-exact restart, checkpoints restored onto the card, the quantized
all-reduce).
This file imports no JAX, so it also runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.lock import (EngineConfig, WorkloadSpec, CostModel,
                                   protocol_params, run_sim)
from repro_torch.core.lock.convert import state_to_numpy
from repro_torch.kernels.grouped_scatter import (segment_sums,
                                                 segment_sums_ref)
from repro_torch.kernels.flash_attention import (
    flash_attention, attention_ref, attention_bf16p_model,
    attention_3xtf32_model, route)
from repro_torch.kernels.flash_attention import kernel_sm90, kernel_tf32
from repro_torch.kernels.flash_attention.ref import (F32_TOL, bf16_errors,
                                                     tf32x3_layout)

PROTOS = ["mysql", "o1", "o2", "group", "bamboo", "brook2pl"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "and the check compares the card with the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,g,dtype,tol", [
    (700, 130, 37, np.float32, 2e-4),        # test_kernels.py:29 tolerances
    (512, 64, 100, np.float16, 2e-2),
    (20_000, 512, 256, np.float32, 2e-4),
    (33, 7, 300, np.float32, 2e-4),
    (50_000, 64, 8, np.float32, 2e-4),       # one group spans many blocks
])
def test_segment_sums_kernel_on_card(card, n, d, g, dtype, tol):
    rng = np.random.default_rng(n + g)
    ids = rng.integers(-1, g + 1, n).astype(np.int32)
    ids[: n * 4 // 5 if g == 8 else 0] = 0
    seg = torch.from_numpy(ids)
    upd = torch.from_numpy(rng.normal(size=(n, d)).astype(dtype))
    seg, upd = seg.cuda(), upd.cuda()
    before = segment_sums.launches
    got = segment_sums(seg, upd, g)
    assert segment_sums.launches == before + 1
    torch.testing.assert_close(got, segment_sums_ref(seg, upd, g),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("proto", PROTOS)
def test_engine_on_card_equals_cpu(card, proto):
    cfg = EngineConfig(
        protocol=protocol_params(proto), costs=CostModel(),
        workload=WorkloadSpec(kind="tpcc", n_rows=256, txn_len=3,
                              n_warehouses=2, write_ratio=0.7),
        n_threads=40, horizon=4_000, p_abort=0.05, attrib=True)
    a = state_to_numpy(run_sim(cfg, device="cuda"))
    b = state_to_numpy(run_sim(cfg, device="cpu"))
    for part in ("th", "rows", "g"):
        for f, x, y in zip(getattr(a, part)._fields, getattr(a, part),
                           getattr(b, part)):
            np.testing.assert_array_equal(x, y, err_msg=f"{part}.{f}")


def _pack(cases, T=40, L=3, device="cpu"):
    from repro_torch.core.lock import engine, stack_lanes
    kind = cases[0].workload.kind
    stat = engine.StaticShape(kind, T, L, cases[0].workload.n_rows)
    dps = [engine.split_config(c, pad_threads=T, pad_len=L,
                               device=device)[1] for c in cases]
    return stat, stack_lanes(dps), stack_lanes(
        [engine.init_state_dyn(stat, dp) for dp in dps])


@pytest.mark.cuda
def test_batched_lanes_on_card_equal_cpu(card):
    """One pack of mixed protocols (p_abort, drain, padded T and L,
    hot_base != 0) through _run_batch, paused at an iteration budget and
    resumed, then segmented: the card's lanes equal the CPU's leaf for
    leaf."""
    from repro_torch.core.lock import engine
    wl = dict(kind="zipf", n_rows=256, txn_len=2, write_ratio=0.7,
              zipf_s=0.9)
    cases = [EngineConfig(protocol=protocol_params(p), costs=CostModel(),
                          workload=WorkloadSpec(**wl, hot_base=hb),
                          n_threads=t, horizon=4_000, p_abort=pa,
                          drain=dr, attrib=True)
             for p, t, pa, dr, hb in [("mysql", 40, 0.0, False, 0),
                                      ("group", 12, 0.05, False, 7),
                                      ("brook2pl", 33, 0.05, False, 0),
                                      ("o2", 40, 0.0, True, 0),
                                      ("bamboo", 20, 0.05, False, 3)]]
    out = {}
    for dev in ("cuda", "cpu"):
        stat, dps, s = _pack(cases, device=dev)
        s = engine._run_batch(stat, dps._replace(
            max_iters=np.full(len(cases), 50, np.int32)), s)
        s = engine._run_batch(stat, dps, s)
        seg = engine._run_seg_batch(stat, dps, _pack(cases, device=dev)[2],
                                    [1_000, 2_000, 1_500, 800, 3_000])
        out[dev] = [state_to_numpy(s), state_to_numpy(seg[0]),
                    state_to_numpy(seg[1])]
    for a, b in zip(out["cuda"], out["cpu"]):
        for x, y in zip(_np_leaves(a), _np_leaves(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _np_leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _np_leaves(t)]
    return [tree]


@pytest.mark.cuda
def test_compacted_sweep_equals_sort_then_cut_on_card(card):
    from repro_torch.sweep import grid, run_sweep
    wl = WorkloadSpec(kind="hotspot_update", txn_len=2, n_rows=512)
    pts = (grid(["mysql", "o2", "group", "bamboo", "brook2pl"], wl,
                [8, 24], horizon=6_000, p_abort=[0.0, 0.05],
                name_fmt="{protocol}_T{n_threads}_p{p_abort}")
           + grid("aria", wl, [8, 24], horizon=6_000))
    a = run_sweep(pts, chunk_size=8, compact=True)
    b = run_sweep(pts, chunk_size=8, compact=False)
    for p in pts:
        assert a[p.name].__dict__ == b[p.name].__dict__, p.name


@pytest.mark.cuda
def test_governed_pack_on_card_equals_cpu(card):
    """A governed pack (skew-ramp drift, the queue rule, epsilon-greedy and
    fixed policies, attribution on) on the card equals its CPU run: every
    metric and every segment record."""
    import dataclasses
    from repro_torch.adaptive import (EpsilonGreedyPolicy, FixedPolicy,
                                      GovernorCell, QueueRulePolicy,
                                      run_governed)
    from repro_torch.core.lock import skew_ramp
    drift = skew_ramp(WorkloadSpec(kind="zipf", txn_len=2, n_rows=256,
                                   zipf_s=0.9), 4, lo=0.3, hi=1.1)

    def cells():
        return [GovernorCell("r", QueueRulePolicy(), drift, 8, attrib=True),
                GovernorCell("e", EpsilonGreedyPolicy(), drift, 24,
                             attrib=True),
                GovernorCell("m", FixedPolicy("mysql"), drift, 12,
                             p_abort=0.05, attrib=True),
                GovernorCell("b", FixedPolicy("brook_guard"), drift, 8)]
    a = run_governed(cells(), horizon=12_000, n_segments=4, device="cuda")
    b = run_governed(cells(), horizon=12_000, n_segments=4, chunk_size=4,
                     device="cpu")
    for c in cells():
        assert dataclasses.asdict(a[c.name]) == dataclasses.asdict(
            b[c.name]), c.name
        assert a.segments[c.name] == b.segments[c.name], c.name


@pytest.mark.cuda
def test_open_load_serving_on_card_equals_cpu(card):
    """An open-load serving pack (Poisson at several loads, reject and shed
    admission, one credit a slot so slots HALT and are revived, one
    queue-rule cell) on the card equals its CPU run: every result field,
    boundary record and response."""
    import dataclasses
    from repro_torch.adaptive import QueueRulePolicy
    from repro_torch.serving import ServeCell, poisson, serve
    wl = WorkloadSpec(kind="uniform", txn_len=2, n_rows=512,
                      write_ratio=1.0)

    def cells():
        out = [ServeCell(name=f"{adm}_{rate}", workload=wl, n_threads=8,
                         schedule=poisson(rate, 10_000, seed=i),
                         preset="o2", queue_cap=6, admission=adm,
                         max_outstanding=1, sla_us=300.0)
               for i, (adm, rate) in enumerate(
                   (a, r) for a in ("reject", "shed")
                   for r in (0.01, 0.04, 0.2))]
        return out + [ServeCell(name="rule", workload=wl, n_threads=8,
                                schedule=poisson(0.04, 10_000, seed=9),
                                preset="o2", policy=QueueRulePolicy(),
                                admission="wait", max_outstanding=2)]
    a = serve(cells(), seg_ticks=1_250, keep_responses=True, device="cuda")
    b = serve(cells(), seg_ticks=1_250, keep_responses=True, chunk_size=8,
              device="cpu")
    for c in cells():
        assert dataclasses.asdict(a.serving[c.name]) == dataclasses.asdict(
            b.serving[c.name]), c.name
        assert a.segments[c.name] == b.segments[c.name], c.name
    assert a.responses == b.responses
    assert all(a.serving[c.name].completed > 8 for c in cells())


def _flash_inputs(shape, dtype, transposed=False):
    B, Sq, Sk, H, K, D = shape
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))

    def rand(b, s, h):
        if transposed:      # a (B, S, H, D) view of a (B, H, S, D) tensor
            return torch.randn((b, h, s, D), generator=gen, device="cuda"
                               ).to(dtype).transpose(1, 2)
        return torch.randn((b, s, h, D), generator=gen, device="cuda"
                           ).to(dtype)
    return rand(B, Sq, H), rand(B, Sk, K), rand(B, Sk, K)


def _check_flash(q, k, v, causal, tol, want_route, scale=None):
    """One launch on ``want_route``; f32 (the tf32x3 kernel) held to
    ``tol``, bf16 (the wgmma kernel, every head dim) to ref.bf16_errors
    (the model with one bf16 rounding of P, and the bound of the kernel's
    split P)."""
    assert route(q, k, v) == want_route
    before = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    by_route[want_route] += 1
    assert flash_attention.launches_by_route == by_route
    want = attention_ref(q, k, v, causal=causal, scale=scale)
    if want_route == "wgmma":
        e = bf16_errors(got, want, attention_bf16p_model(
            q, k, v, causal=causal, scale=scale), v)
        assert e["ok"], e
    else:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 64, 64, 4, 2, 32),       # tests/test_kernels.py:59-64
    (1, 128, 128, 8, 8, 64),
    (2, 96, 96, 6, 1, 16),
    (1, 256, 256, 2, 2, 128),
    (1, 333, 333, 14, 2, 64),    # qwen2 heads (H/K = 7), ragged tiles
    (2, 37, 100, 4, 2, 32),      # Sq < Sk
    (1, 100, 37, 14, 2, 64),     # Sq > Sk: rows without a key
])
# f32 on the tf32x3 kernel (3xTF32 on the tensor cores): the reference's
# 2e-6. bf16 at every head dim runs the wgmma kernel, which takes P to bf16
# in two parts: it is held to 1.25x the error of the plain model with one
# bf16 rounding of P against the f32 oracle (and to the reference's 2e-2),
# and to its split's bound, 2^-18 max|v| + 2e-6 (head dims 16 and 32 ran on
# an f32 FMA kernel held to 1e-5 until it was retired)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, None)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_on_card(card, shape, dtype, tol, causal):
    q, k, v = _flash_inputs(shape, dtype)
    _check_flash(q, k, v, causal, tol,
                 "tf32x3" if dtype == torch.float32 else "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,transposed", [
    ((2, 1000, 1000, 8, 2, 128), False),   # head dim 128, many tiles
    ((1, 300, 2048, 16, 4, 128), False),   # head dim 128, Sq < Sk
    ((2, 300, 300, 14, 2, 64), True),      # strided (B, H, S, D) data
    ((1, 200, 200, 4, 2, 128), True),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_head_dim_128_and_strided_on_card(card, shape,
                                                       transposed, causal):
    q, k, v = _flash_inputs(shape, torch.bfloat16, transposed)
    _check_flash(q, k, v, causal, None, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 240])
def test_flash_bf16_negative_scale_on_card(card, D):
    """A negative scale at the other bf16 head dims: the wgmma kernel on
    the negated keys, held to the wgmma bar against the f32 oracle at that
    scale."""
    q, k, v = _flash_inputs((1, 100, 100, 4, 2, D), torch.bfloat16)
    _check_flash(q, k, v, True, None, "wgmma", scale=-D ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
def test_flash_bf16_small_head_dim_takes_wgmma_route_on_card(card, D):
    """bf16 at head dims 16 and 32 takes the wgmma kernel (the f32 FMA
    kernel that took them is retired; never the plain version), held to
    the wgmma bar, with a negative scale too (launched on the negated
    keys); a head dim no kernel has raises before any launch."""
    q, k, v = _flash_inputs((1, 100, 100, 4, 2, D), torch.bfloat16)
    _check_flash(q, k, v, True, None, "wgmma")
    _check_flash(q, k, v, True, None, "wgmma", scale=-D ** -0.5)
    before = flash_attention.launches
    q, k, v = _flash_inputs((1, 100, 100, 4, 2, 48), torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("shape,transposed", [
    ((2, 64, 64, 4, 2, 0), False),        # tests/test_kernels.py:59-64
    ((2, 96, 96, 6, 1, 0), False),        # MQA
    ((2, 37, 100, 4, 2, 0), False),       # Sq < Sk, ragged Sk
    ((1, 100, 37, 6, 3, 0), False),       # Sq > Sk: rows without a key
    ((1, 333, 333, 14, 2, 0), False),     # ragged 128-key tiles
    ((2, 300, 1000, 8, 1, 0), False),     # MQA, many tiles, Sq < Sk
    ((1, 200, 333, 4, 2, 0), True),       # strided (B, H, S, D) data
    ((2, 150, 100, 8, 8, 0), True),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_small_head_dims_on_card(card, D, shape, transposed,
                                             causal):
    """The D = 16 and 32 instances (boxes exactly D wide, the 32- and
    64-byte swizzles, one m64nDk16 P V wgmma a k-step) held to the wgmma
    bar: ref.bf16_errors with the split's bound, 2^-18 max|v| + 2e-6, and
    the reference's 2e-2."""
    q, k, v = _flash_inputs(shape[:5] + (D,), torch.bfloat16, transposed)
    _check_flash(q, k, v, causal, None, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 200, 200, 16, 8, 240),   # gemma3-12b's global heads, ragged tiles
    (2, 77, 130, 4, 2, 240),     # Sq < Sk
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_head_dim_240_on_card(card, shape, dtype, tol, causal):
    """gemma3's head dim: f32 takes the tf32x3 kernel's D = 240 instance
    (the reference's 2e-6; Q in f32 in shared memory and registers,
    32-key tiles, P V in thirds), bf16 the wgmma kernel's D = 240 instance (64-key tiles, four
    64-column boxes, the last one's 16 zero-filled columns never stored),
    held to ref.bf16_errors with the split's bound: every one of the 240
    columns is written and matches the plain version."""
    q, k, v = _flash_inputs(shape, dtype)
    _check_flash(q, k, v, causal, tol,
                 "tf32x3" if dtype == torch.float32 else "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,transposed", [
    ((1, 200, 200, 16, 8, 240), True),     # strided (B, H, S, D) data
    ((1, 130, 77, 4, 2, 240), False),      # Sq > Sk: rows without a key
    ((1, 1000, 1000, 16, 8, 240), False),  # many 64-key tiles
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_head_dim_240_on_card(card, shape, transposed, causal):
    q, k, v = _flash_inputs(shape, torch.bfloat16, transposed)
    _check_flash(q, k, v, causal, None, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("D", kernel_sm90.HEAD_DIMS)
def test_flash_wgmma_writes_only_its_output_on_card(card, D):
    """The output is a view into a NaN-filled buffer with one more head and
    one more row: the kernel fills the view (bf16 bar) and leaves the extra
    head and row NaN, so no 64-column box (D = 240's fourth holds 48 real
    columns) and no tile row past Sq is stored."""
    B, Sq, Sk, H, K = 2, 200, 200, 4, 2
    q, k, v = _flash_inputs((B, Sq, Sk, H, K, D), torch.bfloat16)
    buf = torch.full((B, Sq + 1, H + 1, D), float("nan"), device="cuda")
    out = buf[:, :Sq, :H]
    kernel_sm90.launch(q, k, v, out, True, D ** -0.5)
    torch.cuda.synchronize()
    assert bool(buf[:, :, H].isnan().all()) and bool(buf[:, Sq].isnan().all())
    want = attention_ref(q, k, v)
    e = bf16_errors(out, want, attention_bf16p_model(q, k, v), v)
    assert e["ok"], e


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sk,K,D", [(2, 100, 2, 32), (1, 77, 1, 16),
                                      (1, 333, 2, 64), (1, 200, 2, 128),
                                      (2, 130, 2, 240)])
def test_flash_tf32_prep_layout_on_card(card, B, Sk, K, D):
    """The prep kernel writes exactly ref.tf32x3_layout: cvt.rna's TF32 hi,
    lo = x - hi, V^T's key order and zero padding, bit for bit."""
    _, k, v = _flash_inputs((B, 1, Sk, K, K, D), torch.float32)
    got = kernel_tf32.prep(k, v)
    torch.cuda.synchronize()
    for a, b in zip(got, tf32x3_layout(k, v)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((1, 333, 333, 14, 2, 64), True),
                                          ((2, 300, 2048, 14, 2, 64), False),
                                          ((1, 200, 200, 2, 2, 128), True),
                                          ((2, 96, 96, 6, 1, 16), False),
                                          ((1, 200, 200, 16, 8, 240), True),
                                          ((2, 77, 130, 4, 2, 240), False),
                                          ((1, 130, 77, 4, 2, 240), True)])
def test_flash_tf32_kernel_matches_its_model_on_card(card, shape, causal):
    """The tf32x3 kernel against attention_3xtf32_model, the same 3xTF32
    arithmetic in plain PyTorch (they differ in the tensor core's order and
    rounding of sums and ex2.approx), and both against the oracle, within
    the reference's 2e-6: a wrong tile, key order or split moves outputs
    by far more."""
    q, k, v = _flash_inputs(shape, torch.float32)
    got = flash_attention(q, k, v, causal=causal)
    model = attention_3xtf32_model(q, k, v, causal)
    want = attention_ref(q, k, v, causal)
    torch.testing.assert_close(got, model, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(model, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", kernel_tf32.HEAD_DIMS)
def test_flash_tf32_strided_and_writes_only_its_output_on_card(card, D):
    """(B, H, S, D) views of q, k and v, and an output that is a view into
    a NaN-filled buffer with one more head and one more row: the kernel
    meets 2e-6 and leaves the extra head and row NaN."""
    B, Sq, Sk, H, K = 2, 200, 150, 4, 2
    q, k, v = _flash_inputs((B, Sq, Sk, H, K, D), torch.float32,
                            transposed=True)
    assert not q.is_contiguous()
    buf = torch.full((B, Sq + 1, H + 1, D), float("nan"), device="cuda")
    out = buf[:, :Sq, :H]
    kernel_tf32.launch(q, k, v, out, True, D ** -0.5)
    torch.cuda.synchronize()
    assert bool(buf[:, :, H].isnan().all()) and bool(buf[:, Sq].isnan().all())
    torch.testing.assert_close(out, attention_ref(q, k, v), rtol=F32_TOL,
                               atol=F32_TOL)


def _to(tree, dev):
    """A parameter or cache tree (dicts, lists, NamedTuples) on ``dev``."""
    if isinstance(tree, dict):
        return {key: _to(val, dev) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_to(val, dev) for val in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_to(val, dev) for val in tree))
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for val in tree.values() for x in _leaves(val)]
    if isinstance(tree, (list, tuple)):
        return [x for val in tree for x in _leaves(val)]
    return [tree]


NEW_ARCHS = ["deepseek-coder-33b", "gemma3-12b", "command-r-35b",
             "arctic-480b", "deepseek-v2-lite-16b", "recurrentgemma-2b",
             "musicgen-medium", "qwen2-vl-2b", "mamba2-1.3b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_arch_prefill_and_decode_on_card_equal_cpu(card, arch):
    """Each architecture's smoke config in f32 on the same weights: the
    card's prefill (kernel path: one launch per global layer) and decode
    step against the CPU's, logits and caches within 2e-4 relative."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import (lm_spec, init_params, prefill,
                                    decode_step)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              act_dtype="float32")
    cpu = init_params(lm_spec(cfg), 1, device="cpu")
    params = _to(cpu, "cuda")
    rng = np.random.default_rng(2)
    B, S = 2, 24
    if cfg.embed_inputs:
        inp = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, S + 1), dtype=np.int32))}
    else:
        inp = {"embeds": torch.from_numpy(rng.normal(
            size=(B, S + 1, cfg.d_model)).astype(np.float32))}
    if cfg.mrope:
        inp["positions3"] = torch.from_numpy(np.sort(rng.integers(
            0, 3 * S, (3, B, S + 1)), axis=-1).astype(np.int32))

    def cut(sl):
        return {k: (v[:, :, sl] if k == "positions3" else v[:, sl])
                for k, v in inp.items()}

    n_global = sum(reps * sum(m == "global" for m, _ in unit)
                   for unit, reps in cfg.layout)
    out = {}
    for dev, p in (("cpu", cpu), ("cuda", params)):
        before = flash_attention.launches
        lp, caches = prefill(p, cfg, use_kernel=True, max_len=S + 1,
                             device=dev, **_to(cut(slice(0, S)), dev))
        assert flash_attention.launches - before == \
            (n_global if dev == "cuda" else 0)
        ld, caches = decode_step(p, cfg, caches=caches, pos=S, device=dev,
                                 **_to(cut(slice(S, S + 1)), dev))
        out[dev] = [lp, ld] + _leaves(caches)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert a.shape == b.shape
        err = float((a - b.cpu()).abs().max())
        assert err <= 2e-4 * (float(a.abs().max()) + 1e-6), (arch, err)


@pytest.mark.cuda
def test_moe_drops_on_card_equal_cpu(card):
    """deepseek-v2-lite's smoke MoE with 16 slots an expert for 96 tokens
    (the default capacity factor would give 32), so that tokens drop: the
    card routes, counts and drops exactly as the CPU, and the combine
    (index_add_) agrees to rounding."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.moe import moe, moe_spec
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                              act_dtype="float32")
    p = init_params(moe_spec(cfg), 3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 48, cfg.d_model)).astype(np.float32))
    y, st = moe(p, x, cfg, cap=16)
    yc, stc = moe(_to(p, "cuda"), x.cuda(), cfg, cap=16)
    assert int(st.dropped) == int(stc.dropped) > 0
    assert torch.equal(st.expert_counts, stc.expert_counts.cpu())
    torch.testing.assert_close(yc.cpu(), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stc.aux_loss.cpu(), st.aux_loss, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
def test_qwen2_kernel_path_on_card(card):
    """Prefill through the kernel (one launch per layer), then a decode
    step, against the plain path's full forward (f32, 2e-4 relative)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import (lm_spec, init_params, forward, prefill,
                                    decode_step)
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              act_dtype="float32")
    params = init_params(lm_spec(cfg), 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen, device="cuda")
    full = forward(params, cfg, tokens=toks, mode="prefill").logits[:, -1]
    before = flash_attention.launches
    _, caches = prefill(params, cfg, tokens=toks[:, :64], use_kernel=True,
                        max_len=65)
    assert flash_attention.launches == before + cfg.n_layers
    logits, _ = decode_step(params, cfg, tokens=toks[:, 64:], caches=caches,
                            pos=64)
    err = float((full - logits[:, 0]).abs().max())
    assert err / float(full.abs().max()) < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("proto", PROTOS)
def test_traced_run_on_card_equals_cpu(card, proto):
    """A traced run (tpcc, p_abort 0.05) on the card: the same events and
    the same state as on the CPU."""
    from repro_torch.obs import events_host, simulate_traced
    wl = WorkloadSpec(kind="tpcc", n_rows=256, txn_len=4, n_warehouses=4,
                      seed=1)
    run = dict(horizon=6_000, p_abort=0.05, seed=1, cap=65_536)
    if proto != "brook2pl":
        run.update(wait_timeout=8_000, commit_wait_timeout=8_000)
    out = {dev: simulate_traced(proto, wl, 16, device=dev, **run)
           for dev in ("cuda", "cpu")}
    a, b = (events_host(out[d][1]) for d in ("cuda", "cpu"))
    assert a["n"] == b["n"] > 0 and a["dropped"] == b["dropped"] == 0
    for k in ("ts", "tid", "row", "ev"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(_np_leaves(state_to_numpy(out["cuda"][0])),
                    _np_leaves(state_to_numpy(out["cpu"][0]))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_record_adds_no_host_sync(card):
    """The tracer's per-iteration record under CUDA's sync debug mode
    "error": any host synchronisation inside it raises."""
    from repro_torch.core.lock import engine
    from repro_torch.obs import make_trace
    from repro_torch.obs.trace import _Recorder
    cfg = EngineConfig(protocol=protocol_params("mysql"), costs=CostModel(),
                       workload=WorkloadSpec(kind="zipf", n_rows=64,
                                             txn_len=4),
                       n_threads=32, horizon=100_000)
    stat, dp = engine.split_config(cfg, device="cuda")
    step = engine._make_step_events(stat, engine._lanes(dp))
    s = engine._unsqueeze(engine.init_state_dyn(stat, dp))
    rec = _Recorder(make_trace(cap=4096, device="cuda"), 32)
    evs = []
    for _ in range(20):
        s, ev = step(s)
        evs.append(ev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ev in evs:
            rec(ev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tb = rec.buf()
    assert int(tb.n) > 0 and int(tb.dropped) == 0


@pytest.mark.cuda
def test_profile_step_on_card(card):
    from repro_torch.obs import profile_step
    cfg = EngineConfig(protocol=protocol_params("group"), costs=CostModel(),
                       workload=WorkloadSpec(kind="hotspot_update",
                                             n_rows=4096, txn_len=4),
                       n_threads=64, horizon=1_000_000)
    stages = ("commit_cursor", "ticket_grant", "tick_charge")
    prof = profile_step(cfg, n_iters=8, repeats=2, stages=stages,
                        device="cuda")
    assert prof.compiles == len(stages) + 1
    assert abs(sum(r.fraction for r in prof.stages) - 1.0) < 1e-9
    assert prof.us_per_iter > 0


# ------------------------------------------------------- the training half

def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_gradients_on_card(card):
    """A CUDA input that requires grad raises before any launch: the kernels
    return tensors without a grad_fn."""
    q = torch.randn((1, 64, 4, 64), device="cuda", requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device="cuda")
    seg = torch.zeros((8,), dtype=torch.int32, device="cuda")
    upd = torch.ones((8, 4), device="cuda", requires_grad=True)
    before = (flash_attention.launches, segment_sums.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="no backward"):
        segment_sums(seg, upd, 2)
    assert (flash_attention.launches, segment_sums.launches) == before
    with torch.no_grad():
        out = flash_attention(q, kv, kv)
    assert out.grad_fn is None and flash_attention.launches == before[0] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "musicgen-medium",
                                  "qwen2-vl-2b"])
def test_make_batch_equal_on_card_and_cpu(card, arch):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    cfg = get_config(arch, smoke=True)
    dc = DataConfig(seed=5, host_id=1)
    got, _ = make_batch(dc, cfg, 4, 32, init_state())
    want, _ = make_batch(dc, cfg, 4, 32, init_state(), device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b",
                                  "mamba2-1.3b"])
def test_train_step_on_card_matches_cpu(card, arch):
    """One f32 smoke-size step from the same weights and batch: the loss
    within 1e-5 relative, every gradient leaf within 2e-4 of its max |g|
    (tests/torch_train_parity.py's bars), AdamW's new parameters within
    2 lr (a step-1 sign flip) and mostly far closer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, init_state, make_batch
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import init_params, lm_spec
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves as _tree_leaves
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  act_dtype="float32")
        opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1)
        out = {}
        for dev in ("cpu", "cuda"):
            params = _tree_to(init_params(lm_spec(cfg), 0, device="cpu"),
                              dev)
            batch, _ = make_batch(DataConfig(), cfg, 2, 32, init_state(),
                                  device=dev)
            loss, _, grads = value_and_grad(params, cfg, batch, device=dev)
            new, _, m = make_train_step(cfg, opt_cfg, device=dev)(
                params, adamw.init(params), batch)
            out[dev] = (float(loss), [g.cpu() for g in _tree_leaves(grads)],
                        [p.cpu() for p in _tree_leaves(new)], float(m["lr"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (l0, g0, p0, lr), (l1, g1, p1, _) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    moved = total = 0
    for a, b, pa, pb in zip(g0, g1, p0, p1):
        assert float((a - b).abs().max()) <= 2e-4 * float(a.abs().max()) \
            + 1e-12
        diff = (pa - pb).abs()
        assert float(diff.max()) <= 2 * lr * 1.001 + 1e-6
        moved += int((diff > 1e-3 * lr).sum())
        total += diff.numel()
    assert moved <= 0.01 * total, (moved, total)


@pytest.mark.cuda
def test_train_restart_on_card_is_bit_exact(card, tmp_path):
    from repro_torch.launch.train import train
    kw = dict(arch="qwen2-0.5b", smoke=True, batch=4, seq=64, ckpt_every=2,
              device="cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        full = train(steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
        first = train(steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
        rest = train(steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert first == full[:2] and rest == full[2:], (full, first, rest)


@pytest.mark.cuda
def test_grouped_embed_on_card(card):
    """The grouped gradient equals autograd's indexing backward and the
    CPU's, on Zipf tokens."""
    from repro_torch.optim import grouped_embed, serial_embed
    rng = np.random.default_rng(0)
    table = rng.normal(size=(512, 64)).astype(np.float32)
    tokens = np.minimum(rng.zipf(1.2, (8, 256)) - 1, 511).astype(np.int64)
    ct = rng.normal(size=(8, 256, 64)).astype(np.float32)
    grads = {}
    for name, fn, dev in (("grouped", grouped_embed, "cuda"),
                          ("serial", serial_embed, "cuda"),
                          ("cpu", grouped_embed, "cpu")):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        out = fn(t, torch.from_numpy(tokens).to(dev))
        (g,) = torch.autograd.grad(out, t, torch.from_numpy(ct).to(dev))
        grads[name] = g.cpu()
    torch.testing.assert_close(grads["grouped"], grads["serial"], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(grads["grouped"], grads["cpu"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_checkpoint_restores_onto_card_bit_for_bit(card, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((64, 8), generator=g).to(torch.bfloat16),
            "m": torch.randn((64, 8), generator=g),
            "q": torch.randint(-127, 128, (4, 3), generator=g,
                               dtype=torch.int8)}
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree_to(tree, "cuda"))
    ck.wait()
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    for got in (ck.restore(3, _tree_to(like, "cuda")),
                ck.restore(3, like, device="cuda")):
        for k, v in tree.items():
            assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
            assert torch.equal(got[k].cpu().view(torch.int16)
                               if v.dtype == torch.bfloat16 else got[k].cpu(),
                               v.view(torch.int16)
                               if v.dtype == torch.bfloat16 else v)


@pytest.mark.cuda
def test_quantized_psum_single_rank_on_card(card):
    from repro_torch.optim import quantized_psum
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5000,)).astype(np.float32)
    r = (0.01 * rng.normal(size=(5000,))).astype(np.float32)
    want = quantized_psum(torch.from_numpy(x), residual=torch.from_numpy(r))
    got = quantized_psum(torch.from_numpy(x).cuda(),
                         residual=torch.from_numpy(r).cuda())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
