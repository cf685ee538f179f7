"""The bf16 route of the port's flash attention, checked on the CPU.

The wgmma kernel (``csrc/flash_attention_sm90.cu``) runs only on the card;
here its plain model ``attention_bf16p_model`` (online softmax over the
kernel's key tiles: 128 keys, 64 at head dim 240; exp2 with the folded
scale, P rounded to bf16 before PV) is held to the JAX reference's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and oracle at the
reference's bf16 bar, its tiling is shown exact in f32 with the rounding
off, and the bar built on it (``ref.bf16_errors``) is shown to pass the
model and fail a fault. Also the routing rule (dtype and head dim), the
wrappers' stride rule per dtype, the ptxas report parser the smoke prints
registers with, and each kernel instance's shared memory, registers and
column boxes read from the source.
"""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention as ref_flash,
                                           attention_ref as ref_attention)
from repro_torch.kernels.flash_attention import (attention_bf16p_model,
                                                 attention_ref, route)
from repro_torch.kernels.flash_attention import kernel_sm90
from repro_torch.kernels.flash_attention.ops import _aligned
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
                                   (1, 200, 200, 16, 8, 240)])
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
    """bf16 at head dims 64, 128 and 240 (gemma3-12b's global layers) takes
    the wgmma kernel; f32 at every head dim (240 included) the 3xTF32 wgmma
    kernel; bf16 at 16 and 32 (the reference's test shapes only) the f32
    FMA kernel."""
    q = torch.empty((1, 8, 4, D), dtype=dtype, device="meta")
    kv = torch.empty((1, 8, 2, D), dtype=dtype, device="meta")
    if dtype == torch.bfloat16:
        want = "wgmma" if D in (64, 128, 240) else "fma"
    else:
        want = "tf32x3"
    assert route(q, kv, kv) == want


@pytest.mark.parametrize("dtype,copied", [(torch.bfloat16, True),
                                          (torch.float32, False)])
def test_aligned_stride_rule_per_dtype(dtype, copied):
    """A view whose head stride is 4 elements is 8 bytes in bf16, which a
    TMA tensor map cannot take, so it is copied; in f32 it is 16 bytes and
    the FMA kernel reads it in place. A bf16 stride of 8 elements is read
    in place."""
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
    """Per instance, from the source: shared memory within the 232,448 B a
    block may use (Q boxes, two rings of K and V tiles, the alignment pad
    and the barriers, as ``Cfg::SMEM`` adds them); registers within the
    SM's 65,536 (with a producer warpgroup, which keeps 24 a thread through
    setmaxnreg, 128·NC·CONSUMER_REGS + 128·24; without one, every thread
    at the consumers' count); enough 64-column boxes to cover D; and the
    key tile ``kernel_sm90.BLOCK_K`` (and so the plain model's default
    tile) names."""
    shapes = _instance_shapes()
    assert sorted(shapes) == sorted(kernel_sm90.HEAD_DIMS)
    sh = shapes[D]
    nc, regs, bk, stages = (sh["NC"], sh["CONSUMER_REGS"], sh["BK"],
                            sh["STAGES"])
    chunks = -(-D // 64)
    q_box, box = 64 * nc * 128, bk * 128
    smem = chunks * q_box + 2 * stages * chunks * box + 1024 + 256
    assert smem <= 232_448, (D, smem)
    if sh["PRODUCER_WARPS"] == 4:
        assert 128 * nc * regs + 128 * 24 <= 65_536, (D, nc, regs)
        assert regs % 8 == 0 and regs <= 240          # setmaxnreg's range
    else:
        assert sh["PRODUCER_WARPS"] == 0
        assert 128 * nc * regs <= 65_536 and regs <= 255, (D, nc, regs)
    assert chunks * 64 >= D and D % 16 == 0
    assert D % sh["PV_N"] == 0 and (sh["PV_N"] == 64 or sh["PV_N"] == D)
    assert kernel_sm90.BLOCK_K[D] == bk
    if D == 240:   # 64-key tiles, a two-stage ring, one n240 P V, no producer
        assert (nc, bk, stages, sh["PV_N"], sh["PRODUCER_WARPS"], smem) == \
            (2, 64, 2, 240, 0, 197_888)


@pytest.mark.parametrize("shape,causal", [((1, 333, 333, 14, 2, 64), True),
                                          ((1, 100, 37, 14, 2, 64), True),
                                          ((1, 256, 256, 2, 2, 128), False),
                                          ((2, 37, 100, 4, 2, 32), True),
                                          ((1, 200, 200, 16, 8, 240), True),
                                          ((2, 77, 130, 4, 2, 240), False)])
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
