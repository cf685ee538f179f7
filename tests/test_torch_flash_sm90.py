"""The bf16 route of the port's flash attention, checked on the CPU.

The wgmma kernel (``csrc/flash_attention_sm90.cu``) runs only on the card;
here its plain model ``attention_bf16p_model`` (online softmax over the
kernel's key tiles: 128 keys, 64 at head dim 240; exp2 with the folded
scale, P rounded to bf16 before PV) is held to the JAX reference's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and oracle at the
reference's bf16 bar, its tiling is shown exact in f32 with the rounding
off, and the bar built on it (``ref.bf16_errors``) is shown to pass the
model and fail a fault. Also the routing rule (bf16 at every head dim, 16
and 32 included), a negative scale on negated keys, the wrappers'
stride rule per dtype, the ptxas report parser the smoke prints registers
with, and each kernel instance's shared memory, registers, column boxes
and swizzle read from the source.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention as ref_flash,
                                           attention_ref as ref_attention)
from repro_torch.kernels.flash_attention import (attention_bf16p_model,
                                                 attention_ref,
                                                 flash_attention, route)
from repro_torch.kernels.flash_attention import kernel_sm90
from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS, ROUTES,
                                                     _aligned, checked_route,
                                                     wgmma_operands)
from repro_torch.kernels.flash_attention.ref import (bf16_errors,
                                                     split_p_bound)
from repro_torch.kernels.nvcc_build import ptxas_usage

BF16_TOL = 2e-2                                  # tests/test_kernels.py:74

SQUARE = [
    (2, 64, 64, 4, 2, 32),      # GQA           (test_kernels.py:59-64)
    (1, 128, 128, 8, 8, 64),    # MHA
    (2, 96, 96, 6, 1, 16),      # MQA
    (1, 256, 256, 2, 2, 128),   # long-ish
    (1, 333, 333, 14, 2, 64),   # qwen2 heads, ragged 128-key tiles
]
UNEQUAL = [
    ((2, 37, 100, 4, 2, 32), True),      # fewer queries than keys
    ((1, 100, 37, 14, 2, 64), True),     # more: rows 0..62 see no key
    ((1, 48, 80, 6, 3, 16), False),
    ((1, 1, 33, 14, 2, 64), True),       # one decode-like query
]
# gemma3-12b's head dim 240, on the kernel's 64-key tiles (kept apart from
# the lists above so that their cases keep their ids)
SQUARE_240 = [
    (1, 256, 256, 4, 2, 240),   # the Pallas kernel's blocks (interpret)
    (1, 200, 200, 16, 8, 240),  # gemma3-12b's 16/8 heads, ragged tiles
]
UNEQUAL_240 = [((2, 77, 130, 4, 2, 240), True)]     # fewer queries than keys


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, Sk, H, K, D, dtype):
    """The same numpy draws for both packages, rounded to bf16 on the JAX
    side and carried over exactly."""
    rng = np.random.default_rng(seed)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = [jnp.asarray(rng.normal(size=s), dt) for s in
         ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]
    t = [torch.from_numpy(np.array(a, np.float32)) for a in j]
    if dtype == "bfloat16":
        t = [a.to(torch.bfloat16) for a in t]
    return j, t


@pytest.mark.parametrize("shape", SQUARE + SQUARE_240)
def test_model_vs_reference_kernel_bf16(shape):
    """Sq == Sk, causal: the Pallas kernel's top-left mask equals the
    oracle's bottom-right one, so both references apply."""
    B, Sq, Sk, H, K, D = shape
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), *shape, "bfloat16")
    got = attention_bf16p_model(q, k, v, causal=True)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_flash(jq, jk, jv, causal=True)),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_attention(jq, jk, jv, causal=True)),
        rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("shape,causal", UNEQUAL + UNEQUAL_240)
def test_model_unequal_lengths_vs_oracle_bf16(shape, causal):
    """Sq != Sk: the model computes the oracle's bottom-right mask, rows
    without a visible key included."""
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), *shape, "bfloat16")
    np.testing.assert_allclose(
        attention_bf16p_model(q, k, v, causal).numpy(),
        np.asarray(ref_attention(jq, jk, jv, causal=causal)),
        rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("block_k", [16, 128, 64])
@pytest.mark.parametrize("shape,causal",
                         [(s, True) for s in SQUARE] + UNEQUAL
                         + [((1, 300, 300, 2, 1, 64), False)]
                         + [(s, True) for s in SQUARE_240] + UNEQUAL_240)
def test_model_tiling_is_exact_in_f32(shape, causal, block_k):
    """f32 inputs with the bf16 rounding of P switched off: the online
    softmax over key tiles, exp2 with the folded scale and the -2e38 fill
    give the oracle's function to f32 rounding (the reference's 2e-6), at
    the kernel's 128-key tiles (64 at head dim 240) and at 16-key ones,
    which cross many tile edges at these sizes."""
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape) + block_k, *shape,
                                      np.float32)
    got = attention_bf16p_model(q, k, v, causal, block_k=block_k,
                                round_p=False)
    torch.testing.assert_close(got, attention_ref(q, k, v, causal),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_attention(jq, jk, jv,
                                                        causal=causal)),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shape", [(1, 333, 333, 14, 2, 64),
                                   (2, 37, 100, 4, 2, 64),
                                   (1, 200, 200, 16, 8, 240),
                                   (1, 333, 333, 8, 2, 16),
                                   (2, 37, 100, 4, 1, 32)])
def test_bf16_bar_passes_the_model_and_fails_a_fault(shape):
    """The bar of the wgmma route: the model meets it against itself, a
    second draw of the same rounding (P rounded after a 1-ulp change of the
    scale) meets it too, and a fault (a causal mask shifted by one key)
    does not."""
    (_, _, _), (q, k, v) = _inputs(7, *shape, "bfloat16")
    want = attention_ref(q, k, v)
    model = attention_bf16p_model(q, k, v)
    e = bf16_errors(model, want, model)
    assert e["ok"] and 1e-4 < e["model_max_abs"] < BF16_TOL
    scale = float(np.nextafter(np.float32(shape[-1] ** -0.5), np.float32(1)))
    e = bf16_errors(attention_bf16p_model(q, k, v, scale=scale), want, model)
    assert e["ok"], e
    shifted = attention_bf16p_model(q[:, :-1], k[:, :-2], v[:, :-2])
    fault = torch.cat([shifted, model[:, -1:]], dim=1)
    e = bf16_errors(fault, want, model)
    assert not e["ok"] and e["max_abs"] > 10 * e["model_max_abs"], e


@pytest.mark.parametrize("D", [16, 32, 64, 128, 240])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_dtype_and_head_dim(dtype, D):
    """bf16 at every head dim (16 and 32, the reference's test shapes and
    the smoke configurations', as well as 64, 128 and 240) takes the wgmma
    kernel; f32 at every head dim the 3xTF32 wgmma kernel. No other route
    exists: the f32 FMA kernel that took bf16 at 16 and 32 is retired."""
    q = torch.empty((1, 8, 4, D), dtype=dtype, device="meta")
    kv = torch.empty((1, 8, 2, D), dtype=dtype, device="meta")
    want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert route(q, kv, kv) == want
    assert ROUTES == ("wgmma", "tf32x3") and D in HEAD_DIMS
    assert D in kernel_sm90.HEAD_DIMS


@pytest.mark.parametrize("D", [16, 32, 64, 128, 240])
def test_negative_scale_takes_wgmma_on_negated_keys(D):
    """The wgmma kernel folds the scale into one FFMA and takes the max of
    the raw scores, so it needs ``scale >= 0``; a bf16 call with a negative
    scale takes the wgmma route at every head dim, with no error, and
    launches on ``-k`` with ``-scale`` (``wgmma_operands``). That is exact:
    the plain version and the kernel's arithmetic model on (q, -k, |s|)
    equal, bit for bit, themselves on (q, k, s)."""
    q = torch.empty((1, 8, 4, D), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 8, 2, D), dtype=torch.bfloat16, device="meta")
    assert checked_route(q, kv, kv) == "wgmma"
    s = -D ** -0.5
    g = torch.Generator().manual_seed(D)
    qc = torch.randn((2, 37, 4, D), generator=g).bfloat16()
    kc, vc = (torch.randn((2, 37, 2, D), generator=g).bfloat16()
              for _ in range(2))
    k2, s2 = wgmma_operands(kc, s)
    assert s2 == -s > 0 and torch.equal(k2, -kc)
    assert wgmma_operands(kc, -s) == (kc, -s)
    for fn in (attention_ref, attention_bf16p_model):
        want = fn(qc, kc, vc, causal=True, scale=s)
        assert torch.equal(fn(qc, k2, vc, causal=True, scale=s2), want)
    before = flash_attention.launches
    # on CPU tensors the wrapper runs the plain version, which takes it
    assert torch.equal(flash_attention(qc, kc, vc, scale=s),
                       attention_ref(qc, kc, vc, scale=s))
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype,copied", [(torch.bfloat16, True),
                                          (torch.float32, False)])
def test_aligned_stride_rule_per_dtype(dtype, copied):
    """A view whose head stride is 4 elements is 8 bytes in bf16, which a
    TMA tensor map cannot take, so it is copied; in f32 it is 16 bytes,
    which the tf32x3 route reads in place. A bf16 stride of 8 elements is
    read in place."""
    t = torch.zeros((2, 8, 3, 4), dtype=dtype)      # strides (96, 12, 4, 1)
    out = _aligned(t)
    assert (out is not t) == copied
    torch.testing.assert_close(out, t)
    wide = torch.zeros((2, 8, 3, 8), dtype=torch.bfloat16)[:, :, :, :8]
    assert wide.stride() == (192, 24, 8, 1) and _aligned(wide) is wide
    tt = torch.zeros((2, 3, 8, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert _aligned(tt) is tt                        # (B, S, H, D) view


def test_ptxas_usage_reads_registers_and_spills():
    report = (
        "ptxas info    : Compiling entry function "
        "'_ZN1n17flash_sm90_kernelILi64EEEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1a\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1b' for 'sm_90a'\n"
        "    48 bytes stack frame, 104 bytes spill stores, 128 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers\n")
    a, b = ptxas_usage(report)
    assert a == {"kernel": "_ZN1n17flash_sm90_kernelILi64EEEv",
                 "registers": 128,
                 "stack_bytes": 0, "spill_store_bytes": 0,
                 "spill_load_bytes": 0}
    assert (b["registers"], b["spill_store_bytes"]) == (168, 104)
    assert kernel_sm90.instance_name(64) in a["kernel"]
    assert kernel_sm90.instance_name(128) not in a["kernel"]
    assert ptxas_usage("") == []


def test_head_dims_match_the_source():
    """The launcher's switch has one kernel instance per head dim of
    HEAD_DIMS, and no other."""
    src = kernel_sm90.SOURCE.read_text()
    entry = src[src.index('extern "C" int flash_attention_sm90_launch'):]
    cases = re.findall(r"case (\d+):\s+return launch<(\d+)>", entry)
    assert [(int(a), int(b)) for a, b in cases] == \
        [(d, d) for d in kernel_sm90.HEAD_DIMS]


def _instance_shapes() -> dict:
    """Each instance's ``Shape<D>`` line of the .cu file: D -> {NC,
    PRODUCER_WARPS, CONSUMER_REGS, BK, STAGES, PV_N}."""
    src = kernel_sm90.SOURCE.read_text()
    found = re.findall(r"template <> struct Shape<(\d+)> \{\s*static "
                       r"constexpr int ([^;]*);", src)
    return {int(d): {k.strip(): int(v) for k, v in
                     (f.split("=") for f in fields.split(","))}
            for d, fields in found}


@pytest.mark.parametrize("D", kernel_sm90.HEAD_DIMS)
def test_instance_fits_an_sm(D):
    """Per instance, from the source: the box width (``Cfg::BOX``, D below
    a threshold, else a fixed width) and its swizzle (a box row of 2 BOX
    bytes is the 128-, 64- or 32-byte swizzle's row: D = 16 and 32 take
    boxes exactly D wide); shared memory within the 232,448 B a block may
    use (Q boxes, two rings of K and V tiles, the alignment pad and the barriers,
    as ``Cfg::SMEM`` adds them); registers (with a producer warpgroup,
    which keeps 24 a thread through setmaxnreg, 128·NC·CONSUMER_REGS +
    128·24 within the pool the CTA launched with, its threads times the
    count ``__launch_bounds__`` caps, a multiple of 8: setmaxnreg moves
    registers within that pool and an increase past it waits forever;
    without one, every thread at the consumers' count within the SM's
    65,536); enough boxes to cover D; the P V width; and the key tile
    ``kernel_sm90.BLOCK_K`` (and so the plain model's default tile)
    names."""
    shapes = _instance_shapes()
    assert sorted(shapes) == sorted(kernel_sm90.HEAD_DIMS)
    sh = shapes[D]
    nc, regs, bk, stages = (sh["NC"], sh["CONSUMER_REGS"], sh["BK"],
                            sh["STAGES"])
    below, wide = map(int, re.search(
        r"static constexpr int BOX = D < (\d+) \? D : (\d+);",
        kernel_sm90.SOURCE.read_text()).groups())
    box = D if D < below else wide
    row = 2 * box                                # bytes: the swizzle's row
    assert row in (32, 64, 128)
    chunks = -(-D // box)
    q_box, tile = 64 * nc * row, bk * row
    smem = chunks * q_box + 2 * stages * chunks * tile + 1024 + 256
    assert smem <= 232_448, (D, smem)
    assert 64 * nc <= 256 and bk in (64, 128)   # TMA box rows; the wgmmas
    if sh["PRODUCER_WARPS"] == 4:
        threads = 128 * nc + 128
        pool = threads * (65_536 // threads // 8 * 8)
        assert 128 * nc * regs + 128 * 24 <= pool, (D, nc, regs, pool)
        assert regs % 8 == 0 and regs <= 240          # setmaxnreg's range
    else:
        assert sh["PRODUCER_WARPS"] == 0
        assert 128 * nc * regs <= 65_536 and regs <= 255, (D, nc, regs)
    assert chunks * box >= D and D % 16 == 0
    pv_n = sh["PV_N"]
    assert pv_n % 16 == 0 and pv_n <= min(256, chunks * box)
    assert (pv_n == box and D % box == 0) or pv_n >= D
    assert kernel_sm90.BLOCK_K[D] == bk
    if D == 240:   # 64-key tiles, a two-stage ring, one n240 P V, no producer
        assert (nc, bk, stages, pv_n, sh["PRODUCER_WARPS"], smem) == \
            (2, 64, 2, 240, 0, 197_888)
    if D in (16, 32):   # exact-width boxes, one m64nDk16 P V a k-step
        assert (box, pv_n, chunks) == (D, D, 1)


@pytest.mark.parametrize("shape,causal", [((1, 333, 333, 14, 2, 64), True),
                                          ((1, 100, 37, 14, 2, 64), True),
                                          ((1, 256, 256, 2, 2, 128), False),
                                          ((2, 37, 100, 4, 2, 32), True),
                                          ((1, 200, 200, 16, 8, 240), True),
                                          ((2, 77, 130, 4, 2, 240), False),
                                          ((2, 96, 96, 6, 1, 16), True),
                                          ((1, 100, 37, 6, 3, 16), False)])
def test_split_p_model_within_its_bound(shape, causal):
    """P split into bf16 hi + lo (the kernel's default): the model stays
    within split_p_bound of the f32 oracle, ~2^9 times closer than one
    bf16 rounding of P, and with the rounding off it is exact in f32."""
    (_, _, _), (q, k, v) = _inputs(sum(shape), *shape, "bfloat16")
    want = attention_ref(q, k, v, causal)
    split = attention_bf16p_model(q, k, v, causal, split_p=True)
    one = attention_bf16p_model(q, k, v, causal)
    err_split = float((split - want).abs().max())
    assert err_split <= split_p_bound(v)
    assert err_split * 50 < float((one - want).abs().max())
    e = bf16_errors(split, want, one, v)
    assert e["ok"] and e["split_p_bound"] == split_p_bound(v)
    torch.testing.assert_close(
        attention_bf16p_model(q, k, v, causal, round_p=False, split_p=True),
        want, rtol=2e-6, atol=2e-6)


def test_split_p_bound_sees_what_one_bf16_rounding_misses():
    """The bound is 2^-18 max|v| plus the f32 bar: one bf16 rounding of P
    (the unsplit schedules) lies far outside it."""
    (_, _, _), (q, k, v) = _inputs(3, 1, 333, 333, 14, 2, 64, "bfloat16")
    assert split_p_bound(v) == pytest.approx(
        2.0 ** -18 * float(v.float().abs().max()) + 2e-6)
    want = attention_ref(q, k, v)
    one = attention_bf16p_model(q, k, v)
    assert bf16_errors(one, want, one)["ok"]
    assert not bf16_errors(one, want, one, v)["ok"]


def test_variant_switches_patch_applies():
    """tools/flash_sm90_small_variants.patch, which adds the D = 16 and 32
    designs not kept (BOX, OVERLAP, STAGGER, 256-key tiles) to a copy of
    the source for tools/flash_sm90_variants.py, still applies to the
    shipped source, hunk by hunk; its copy names the switches at their
    defaults in both Shape lines, and every variant's Shape lines are found
    in it."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "flash_sm90_variants", root / "tools" / "flash_sm90_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = kernel_sm90.SOURCE.read_text()
    assert "OVERLAP" not in src and "STAGGER" not in src
    patched = tool.apply_patch(src, tool.SWITCHES.read_text())
    for d in (16, 32):
        assert re.search(rf"struct Shape<{d}> \{{[^}}]*BOX = {d}, "
                         rf"OVERLAP = 0, STAGGER = 0; \}};", patched)
    assert "m64n256k16" in patched and "bar.sync" in patched
    for name, lines in tool.PARTS["small"].items():
        for d in (lines or {}):
            assert len(re.findall(
                rf"template <> struct Shape<{d}> \{{[^}}]*\}};", patched)) == 1
