"""Port parity: the flash attention wrapper (on CPU tensors it runs its plain
version) against the JAX reference's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and its oracle ``attention_ref``, at the
reference tests' shapes and tolerances, plus qwen2's H/K = 7 and Sq != Sk."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention as ref_flash,
                                           attention_ref as ref_attention)
from repro_torch.kernels.flash_attention import flash_attention, attention_ref
from repro_torch.kernels.flash_attention.ops import _aligned

TOL = {np.float32: 2e-6, "bfloat16": 2e-2}      # tests/test_kernels.py:74


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


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 4, 2, 32),      # GQA           (test_kernels.py:59-64)
    (1, 128, 128, 8, 8, 64),    # MHA
    (2, 96, 96, 6, 1, 16),      # MQA
    (1, 256, 256, 2, 2, 128),   # long-ish
    (1, 64, 64, 14, 2, 64),     # qwen2-0.5b heads: H/K = 7
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flash_vs_reference_kernel(shape, dtype):
    B, Sq, Sk, H, K, D = shape
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), B, Sq, Sk, H, K, D, dtype)
    want = np.asarray(ref_flash(jq, jk, jv, causal=True))
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, D)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_flash_noncausal_vs_reference_kernel():
    (jq, jk, jv), (q, k, v) = _inputs(3, 1, 64, 64, 2, 2, 32, np.float32)
    np.testing.assert_allclose(
        flash_attention(q, k, v, causal=False).numpy(),
        np.asarray(ref_flash(jq, jk, jv, causal=False)), rtol=2e-6,
        atol=2e-6)


@pytest.mark.parametrize("shape,causal", [
    ((2, 37, 100, 4, 2, 32), True),      # fewer queries than keys
    ((1, 100, 37, 14, 2, 64), True),     # more: rows 0..62 see no key
    ((1, 48, 80, 6, 3, 16), False),
    ((1, 1, 33, 14, 2, 64), True),       # one decode-like query
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flash_unequal_lengths_vs_attention_ref(shape, causal, dtype):
    """Sq != Sk: the port computes the oracle's bottom-right mask."""
    B, Sq, Sk, H, K, D = shape
    (jq, jk, jv), (q, k, v) = _inputs(sum(shape), B, Sq, Sk, H, K, D, dtype)
    want = np.asarray(ref_attention(jq, jk, jv, causal=causal))
    tol = TOL[dtype]
    np.testing.assert_allclose(flash_attention(q, k, v, causal).numpy(),
                               want, rtol=tol, atol=tol)
    np.testing.assert_allclose(attention_ref(q, k, v, causal).numpy(), want,
                               rtol=tol, atol=tol)


def test_causal_alignment_differs_from_the_tpu_kernel():
    """The Pallas kernel aligns the causal mask top-left (qpos >= kpos), its
    oracle bottom-right; they part when Sq != Sk. The port follows the
    oracle (ROADMAP queue 3 records this input and both values)."""
    (jq, jk, jv), (q, k, v) = _inputs(0, 1, 4, 8, 2, 2, 16, np.float32)
    tpu = np.asarray(ref_flash(jq, jk, jv, causal=True))
    oracle = np.asarray(ref_attention(jq, jk, jv, causal=True))
    got = flash_attention(q, k, v, causal=True).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-6, atol=2e-6)
    assert np.abs(got - tpu).max() > 1e-2


def test_aligned_copies_only_what_the_kernel_cannot_read():
    t = torch.zeros((2, 8, 3, 16))
    assert _aligned(t) is t
    tt = t.transpose(1, 2)          # strides (384, 16, 48, 1): readable
    assert _aligned(tt) is tt
    off = torch.zeros(1 + t.numel())[1:].view(t.shape)   # base 4 bytes off
    out = _aligned(off)
    assert out is not off and out.data_ptr() % 16 == 0
    torch.testing.assert_close(out, off)
