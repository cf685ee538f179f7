"""The f32 tensor-core route of the port's flash attention, checked on the CPU.

The tf32x3 kernel (``csrc/flash_attention_tf32.cu``) runs only on the card;
here its plain model ``attention_3xtf32_model`` (online softmax over the
kernel's key tiles, every product as hi.lo + lo.hi + hi.hi with hi = TF32
rounded to nearest and lo truncated, exp2 with the folded scale) is held to
the JAX reference's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it) and its oracle at the reference's f32 bar, 2e-6; the prep kernel's
layout (``tf32x3_layout``) is checked in plain PyTorch; and the routing
table, the TF32 rounding, and each instance's key tile, shared memory and
registers read from the source.
"""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention as ref_flash,
                                           attention_ref as ref_attention)
from repro_torch.kernels.flash_attention import (attention_3xtf32_model,
                                                 attention_ref, route)
from repro_torch.kernels.flash_attention import kernel_sm90, kernel_tf32
from repro_torch.kernels.flash_attention.ops import KERNELS
from repro_torch.kernels.flash_attention.ref import (KEY_ORDER, F32_TOL,
                                                     tf32_rna, tf32_trunc,
                                                     tf32x3_layout)
from repro_torch.kernels.nvcc_build import ptxas_usage

SQUARE = [
    (2, 64, 64, 4, 2, 32),      # GQA           (test_kernels.py:59-64)
    (1, 128, 128, 8, 8, 64),    # MHA
    (2, 96, 96, 6, 1, 16),      # MQA
    (1, 256, 256, 2, 2, 128),   # long-ish
    (1, 333, 333, 14, 2, 64),   # qwen2 heads, ragged 64-key tiles
    (1, 200, 200, 16, 8, 240),  # gemma3-12b's global heads, 32-key tiles
]
UNEQUAL = [
    ((2, 37, 100, 4, 2, 32), True),      # fewer queries than keys
    ((1, 100, 37, 14, 2, 64), True),     # more: rows 0..62 see no key
    ((1, 48, 80, 6, 3, 16), False),
    ((1, 1, 33, 14, 2, 64), True),       # one decode-like query
    ((1, 70, 150, 4, 2, 128), True),     # head dim 128 on 32-key tiles
    ((1, 77, 130, 4, 2, 240), True),     # head dim 240: fewer queries
    ((2, 130, 77, 4, 2, 240), False),    # and more
    ((1, 130, 77, 4, 2, 240), True),     # rows 0..52 see no key
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, Sk, H, K, D):
    """The same numpy draws in f32 for both packages."""
    rng = np.random.default_rng(seed)
    a = [rng.normal(size=s).astype(np.float32) for s in
         ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]
    return [jnp.asarray(x) for x in a], [torch.from_numpy(x) for x in a]


@pytest.mark.parametrize("D", [16, 32, 64, 128, 240])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_table(dtype, D):
    """f32 at every head dim (16, 32, 64, 128 and 240) takes the tf32x3
    kernel and bf16 the wgmma kernel (which took over bf16 at 16 and 32
    from the retired FMA kernel); and every route lands on a kernel module
    with an instance at that head dim."""
    q = torch.empty((1, 8, 4, D), dtype=dtype, device="meta")
    kv = torch.empty((1, 8, 2, D), dtype=dtype, device="meta")
    want = "tf32x3" if dtype == torch.float32 else "wgmma"
    assert route(q, kv, kv) == want
    assert KERNELS[want] is {"wgmma": kernel_sm90,
                             "tf32x3": kernel_tf32}[want]
    assert D in KERNELS[want].HEAD_DIMS


@pytest.mark.parametrize("shape", SQUARE)
@pytest.mark.parametrize("causal", [True, False])
def test_model_vs_reference_kernel_f32(shape, causal):
    """Sq == Sk: the model against the Pallas kernel (whose top-left causal
    mask equals the oracle's bottom-right one here) and the oracle, within
    the reference's f32 bar."""
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), *shape)
    got = attention_3xtf32_model(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_flash(jq, jk, jv,
                                                    causal=causal)),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_attention(jq, jk, jv,
                                                        causal=causal)),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape,causal", UNEQUAL)
def test_model_unequal_lengths_vs_oracle_f32(shape, causal):
    """Sq != Sk: the model computes the oracle's bottom-right mask, rows
    without a visible key included, within 2e-6."""
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), *shape)
    np.testing.assert_allclose(
        attention_3xtf32_model(q, k, v, causal).numpy(),
        np.asarray(ref_attention(jq, jk, jv, causal=causal)),
        rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("block_k", [16, 32, 64])
@pytest.mark.parametrize("shape", [(1, 333, 333, 14, 2, 64),
                                   (1, 200, 200, 2, 1, 128),
                                   (1, 200, 200, 4, 2, 240)])
def test_model_tiling_within_the_bar(shape, block_k):
    """At 16-, 32- and 64-key tiles (the kernel's tiles at D = 240 and 128
    are 32, at D = 64 64; 16 is its other design at D = 240) the model
    stays within 2e-6 of the port's oracle, and one TF32 product a pair
    (hi.hi only) would not: the split is what meets the bar."""
    (_, _, _), (q, k, v) = _inputs(sum(shape) + block_k, *shape)
    want = attention_ref(q, k, v)
    torch.testing.assert_close(
        attention_3xtf32_model(q, k, v, block_k=block_k), want,
        rtol=F32_TOL, atol=F32_TOL)
    one = attention_ref(tf32_rna(q), tf32_rna(k), tf32_rna(v))
    assert float(((one - want).abs() / (F32_TOL + F32_TOL * want.abs()))
                 .max()) > 10


def test_tf32_rounding_is_nearest_ties_away():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (cvt.rna.tf32.f32); the tensor core's reading truncates."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0, -2.0 ** -30],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0,
                         -2.0 ** -30], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert torch.equal(tf32_trunc(x), torch.tensor(
        [1.0, -1.0, 1.0, 1 + ulp, 3.0, 0.0, -2.0 ** -30]))
    r = torch.from_numpy(np.random.default_rng(0).normal(
        size=10_000).astype(np.float32))
    hi = tf32_rna(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - hi).abs() <= hi.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("B,Sk,K,D", [(2, 100, 2, 32), (1, 77, 1, 16),
                                      (1, 333, 2, 64), (1, 70, 2, 128),
                                      (2, 130, 2, 240), (1, 16, 1, 240)])
def test_prep_layout_in_plain_torch(B, Sk, K, D):
    """The prep kernel's output as ``tf32x3_layout`` gives it: shapes as
    ``kernel_tf32.scratch_shapes``, keys padded to the key tile and to the
    prep's 32-key blocks, a K row to whole 32-float boxes (256 at D =
    240); hi is TF32 and hi + lo equals k and v exactly; V^T holds each
    group of 8 keys in KEY_ORDER; rows past Sk, columns past D and V^T's
    padded keys are zero."""
    (_, _, _), (_, k, v) = _inputs(B + Sk + K + D, B, 1, Sk, K, K, D)
    k_hi, k_lo, vt_hi, vt_lo = tf32x3_layout(k, v)
    k_shape, v_shape = kernel_tf32.scratch_shapes(D, B, K, Sk)
    assert (2, *k_hi.shape) == k_shape and (2, *vt_hi.shape) == v_shape
    skp, dp = k_shape[2], k_shape[3]
    pad = max(kernel_tf32.BLOCK_K[D], kernel_tf32.PREP_KEYS)
    assert skp % pad == 0 and skp - Sk < pad and pad % 32 == 0
    assert dp % 32 == 0 and D <= dp < D + 32
    for hi in (k_hi, vt_hi):
        assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    kk = (k_hi + k_lo).reshape(B, K, skp, dp)
    assert torch.equal(kk[:, :, :Sk, :D], k.permute(0, 2, 1, 3))
    assert not kk[:, :, Sk:].any() and not kk[..., D:].any()
    order = torch.tensor(KEY_ORDER)
    vt = (vt_hi + vt_lo).reshape(B, K, D, skp // 8, 8)
    back = torch.empty_like(vt)
    back[..., order] = vt                   # position p holds key order[p]
    back = back.reshape(B, K, D, skp).transpose(-1, -2)
    assert torch.equal(back[:, :, :Sk], v.permute(0, 2, 1, 3))
    assert not back[:, :, Sk:].any()


def _instance_shapes() -> dict:
    """Each instance's ``Shape<D>`` line of the .cu file: D -> {BK,
    STAGES, K_STAGES, NC, O_SMEM, Q_SMEM, PV_N[, Q_GROUP, Q_REG]}."""
    src = kernel_tf32.SOURCE.read_text()
    found = re.findall(r"template <> struct Shape<(\d+)> \{ static "
                       r"constexpr int ([^;]*);", src)
    return {int(d): {k.strip(): int(v) for k, v in
                     (f.split("=") for f in fields.split(","))}
            for d, fields in found}


@pytest.mark.parametrize("D", kernel_tf32.HEAD_DIMS)
def test_instance_fits_an_sm(D):
    """Per instance, from the source: BK as ``kernel_tf32.BLOCK_K`` names
    it (and so the model's default tile), 16 or a multiple of the 32-key
    V^T box; 64 query rows a consumer warpgroup and ``BLOCK_Q`` a CTA; P V
    in whole 8-column wgmmas of PV_N columns. Shared memory: the K ring
    (K_STAGES stages of K_hi and K_lo, BK rows padded to whole 32-float
    boxes), the V^T ring (STAGES stages of V^T_hi and V^T_lo), O where it
    lives there (D / 2 floats a thread) and Q's k-steps past the first
    Q_REG where it does (4 floats a thread a k-step), the alignment pad and
    the barriers within the 232,448 B a block may use. Registers a consumer
    thread holds live, within 240 of the 255 a thread of a 256-thread CTA
    may have: with Q in registers, Q's hi and lo (D), the tile's P V
    (PV_N / 2), S and P's hi and lo (BK); with Q in shared memory (split per
    k-step), in Q K^T: the small terms' accumulator, a group's Q_hi K_hi^T
    and their sum (BK / 2 each) and the group's Q_GROUP k-steps of Q's hi
    and lo (8 each), and in P V: the P V
    (PV_N / 2) and P's hi and lo (BK); throughout, Q_REG k-steps of Q in
    f32 (4 each) and O (D / 2) unless it
    lives in shared memory. Q leaves the registers only where its hi and lo
    would not fit there even with O in shared memory, and O only where it
    would not fit there."""
    sh = _instance_shapes()
    assert sorted(sh) == sorted(kernel_tf32.HEAD_DIMS)
    c = sh[D]
    bk, pv_n, o_smem, q_smem = c["BK"], c["PV_N"], c["O_SMEM"], c["Q_SMEM"]
    assert kernel_tf32.BLOCK_K[D] == bk and (bk == 16 or bk % 32 == 0)
    assert 64 * c["NC"] == kernel_tf32.BLOCK_Q
    assert D % pv_n == 0 and pv_n % 8 == 0
    dp = -(-D // 32) * 32
    k_stage, v_stage = 2 * bk * dp * 4, 2 * D * bk * 4
    threads = 128 * c["NC"]
    q_reg = c.get("Q_REG", 0)
    smem = (c["K_STAGES"] * k_stage + c["STAGES"] * v_stage
            + o_smem * threads * D // 2 * 4
            + q_smem * threads * (D // 8 - q_reg) * 16 + 1024 + 256)
    assert smem <= 232_448, (D, smem)
    q_in_regs = D + pv_n // 2 + bk
    if q_smem:
        g = c["Q_GROUP"]
        assert (D // 8) % g == 0
        regs = max(3 * bk // 2 + 8 * g, pv_n // 2 + bk) + 4 * q_reg
    else:
        regs = q_in_regs
    assert regs + (0 if o_smem else D // 2) <= 240, D
    assert bool(q_smem) == (q_in_regs > 240), D
    assert bool(o_smem) == (regs + D // 2 > 240), D
    if D == 64:        # 64-key tiles, 64 KB a stage, two stages
        assert (bk, c["STAGES"], k_stage + v_stage, o_smem) == \
            (64, 2, 65_536, 0)
    if D == 240:       # 32-key tiles, 25 k-steps of Q in f32 in shared
        # memory (102,400 B) and 5 in registers, P V in thirds, O in
        # registers: 212 live registers
        assert (bk, pv_n, q_smem, q_reg, o_smem, smem, regs + D // 2) == \
            (32, 80, 1, 5, 0, 230_656, 212)


def test_launch_switches_match_head_dims():
    """Both C entry points (prep alone, prep + attention) have one instance
    per head dim of HEAD_DIMS, and no other."""
    src = kernel_tf32.SOURCE.read_text()
    for entry, fn in (("flash_attention_tf32_prep", "prep"),
                      ("flash_attention_tf32_launch", "launch")):
        body = src[src.index(f'extern "C" int {entry}'):]
        body = body[:body.index("\n}\n")]
        cases = re.findall(r"case (\d+):\s+return " + fn + r"<(\d+)>", body)
        assert [(int(a), int(b)) for a, b in cases] == \
            [(d, d) for d in kernel_tf32.HEAD_DIMS], entry


def test_instance_name_reads_the_ptxas_report():
    report = ("ptxas info    : Compiling entry function "
              "'_ZN12_GLOBAL__N_117flash_tf32_kernelILi64EEEv14CUtensorMap_"
              "stS1_NS_6ParamsE' for 'sm_90a'\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
              "loads\nptxas info    : Used 180 registers\n")
    (u,) = ptxas_usage(report)
    assert kernel_tf32.instance_name(64) in u["kernel"]
    assert kernel_tf32.instance_name(16) not in u["kernel"]
    assert kernel_sm90.instance_name(64) not in u["kernel"]
    assert (u["registers"], u["spill_store_bytes"]) == (180, 0)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs ``attention_ref`` and launches
    nothing, f32 at the tf32x3 head dims included."""
    from repro_torch.kernels.flash_attention import flash_attention
    (_, _, _), (q, k, v) = _inputs(5, 1, 40, 40, 4, 2, 64)
    before = dict(flash_attention.launches_by_route)
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_ref(q, k, v), rtol=0, atol=0)
    assert flash_attention.launches_by_route == before
    assert set(before) == {"wgmma", "tf32x3"}
