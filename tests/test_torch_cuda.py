"""Port checks that need the NVIDIA card (marker ``cuda``): the CUDA kernels
against their plain versions, the engine on the card against its CPU run,
and the qwen2 serving path through the flash kernel against the plain path.
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
    flash_attention, attention_ref, attention_bf16p_model, route)
from repro_torch.kernels.flash_attention.ref import bf16_errors

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


def _check_flash(q, k, v, causal, tol, want_route):
    """One launch on ``want_route``; f32 held to ``tol``, bf16 on the wgmma
    kernel to ref.bf16_errors (the model with one bf16 rounding of P, and
    the bound of the kernel's split P), bf16 on the FMA kernel (head dims 16
    and 32) to ``tol``."""
    assert route(q, k, v) == want_route
    before = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    by_route[want_route] += 1
    assert flash_attention.launches_by_route == by_route
    want = attention_ref(q, k, v, causal=causal)
    if want_route == "wgmma":
        e = bf16_errors(got, want,
                        attention_bf16p_model(q, k, v, causal=causal), v)
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
# f32 on the FMA kernel: the reference's 2e-6. bf16 at head dims 64 and 128
# runs the wgmma kernel, which takes P to bf16 in two parts: it is held to
# 1.25x the error of the plain model with one bf16 rounding of P against the
# f32 oracle (and to the reference's 2e-2), and to its split's bound,
# 2^-18 max|v| + 2e-6; bf16 at head dims 16 and 32 runs the FMA kernel in
# f32 from the same inputs, held to 1e-5
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_on_card(card, shape, dtype, tol, causal):
    q, k, v = _flash_inputs(shape, dtype)
    wgmma = dtype == torch.bfloat16 and shape[-1] in (64, 128)
    _check_flash(q, k, v, causal, tol, "wgmma" if wgmma else "fma")


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
@pytest.mark.parametrize("D", [16, 32])
def test_flash_bf16_small_head_dim_takes_fma_route_on_card(card, D):
    """bf16 at head dims the wgmma kernel has no instance for takes the
    documented FMA route (never the plain version); a head dim neither
    kernel has raises before any launch."""
    q, k, v = _flash_inputs((1, 100, 100, 4, 2, D), torch.bfloat16)
    _check_flash(q, k, v, True, 1e-5, "fma")
    q, k, v = _flash_inputs((1, 100, 100, 4, 2, 48), torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


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
