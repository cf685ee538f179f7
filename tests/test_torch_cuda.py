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
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 attention_ref)

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
# kernel and plain version both compute in f32 from the same inputs, so bf16
# inputs are held to an f32-sized bar (1e-5), not to the reference's 2e-2,
# which is the bar for bf16 against f32
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_on_card(card, shape, dtype, tol, causal):
    B, Sq, Sk, H, K, D = shape
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal),
                               rtol=tol, atol=tol)


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
