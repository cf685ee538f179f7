"""The loss and remat of the port's train path against the JAX reference:
``cross_entropy``, ``chunked_cross_entropy`` and ``loss_fn`` on the same
numpy inputs and weights (z-loss, labels at -1, padded vocabulary, codebook
heads) in f32 to 1e-6 relative; chunked CE against dense CE; the chunked
path never builds the (B, S, V) logits; remat on against off, equal bit for
bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.models import (lm_spec as ref_lm_spec,
                          init_params as ref_init_params,
                          loss_fn as ref_loss_fn)
from repro.models.lm import (cross_entropy as ref_ce,
                             chunked_cross_entropy as ref_chunked_ce)
from repro_torch.configs import get_config
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import (chunked_cross_entropy, cross_entropy,
                                forward, init_params, lm_spec, loss_fn)
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import leaves as _flat

CPU = "cpu"
B, S = 2, 16
REF_LOSS = jax.jit(ref_loss_fn, static_argnames=("cfg",))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(rng, shape, vocab):
    lab = rng.integers(0, vocab, shape, dtype=np.int32)
    lab.reshape(-1)[::5] = -1                     # masked positions
    return lab


@pytest.mark.parametrize("zloss", [0.0, 1e-4])
@pytest.mark.parametrize("heads", [0, 3])
def test_cross_entropy_matches_reference(zloss, heads):
    """Padded vocabulary (V 40 > vocab 33), labels at -1, z-loss, and
    codebook-shaped logits (B, S, K, V); value and gradient."""
    rng = np.random.default_rng(0)
    vocab, V = 33, 40
    shape = (B, S, heads) if heads else (B, S)
    logits = (3 * rng.normal(size=shape + (V,))).astype(np.float32)
    labels = _labels(rng, shape, vocab)
    want, gwant = jax.value_and_grad(
        lambda lg: ref_ce(lg, jnp.asarray(labels), vocab, zloss))(
            jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(lg, torch.from_numpy(labels), vocab, zloss)
    (g,) = torch.autograd.grad(got, lg)
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gwant), rtol=1e-6,
                               atol=1e-6 * float(np.abs(gwant).max()))


@pytest.mark.parametrize("heads", [1, 2])
def test_chunked_cross_entropy_matches_reference(heads):
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              loss_chunk=4, vocab=200, n_codebooks=heads
                              if heads > 1 else 0)
    rcfg = dataclasses.replace(ref_get_config("qwen2-0.5b", smoke=True),
                               loss_chunk=4, vocab=200,
                               n_codebooks=cfg.n_codebooks)
    rng = np.random.default_rng(1)
    d, V = cfg.d_model, cfg.padded_vocab
    w = rng.normal(size=((heads, d, V) if heads > 1 else (d, V)))
    w = (w / np.sqrt(d)).astype(np.float32)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    labels = _labels(rng, (B, S, heads) if heads > 1 else (B, S), cfg.vocab)
    want = ref_chunked_ce({"w": jnp.asarray(w)}, jnp.asarray(x),
                          jnp.asarray(labels), rcfg)
    got = chunked_cross_entropy({"w": torch.from_numpy(w)},
                                torch.from_numpy(x), torch.from_numpy(labels),
                                cfg)
    assert V > cfg.vocab
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _batch(cfg, rng):
    b = {}
    if cfg.embed_inputs:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    else:
        b["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    lshape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    b["labels"] = _labels(rng, lshape, cfg.vocab)
    return b


@pytest.mark.parametrize("arch,loss_chunk", [
    ("qwen2-0.5b", 0), ("qwen2-0.5b", 8), ("deepseek-v2-lite-16b", 0),
    ("musicgen-medium", 4)])
def test_loss_fn_matches_reference(arch, loss_chunk):
    """The whole loss on the reference's weights: CE (z-loss on) plus 0.01
    times the MoE aux loss (deepseek-v2-lite), dense and chunked."""
    kw = dict(act_dtype="float32", loss_chunk=loss_chunk)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), **kw)
    tree = jax.device_get(ref_init_params(ref_lm_spec(rcfg),
                                          jax.random.PRNGKey(2)))
    batch = _batch(cfg, np.random.default_rng(3))
    want, wm = REF_LOSS(tree, rcfg, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got, gm = loss_fn(params_from_numpy(tree, device=CPU), cfg,
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      device=CPU)
    assert cfg.zloss > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=1e-6)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]),
                               rtol=1e-6, atol=1e-7)
    if arch.startswith("deepseek"):
        assert float(gm["aux"]) > 0


def _grads(cfg, params, batch):
    loss, _, grads = value_and_grad(params, cfg, batch, device=CPU)
    return loss, grads


def test_chunked_ce_matches_dense():
    """tests/test_decode_consistency.py's chunked-vs-dense check in the
    port (z-loss off, f32), gradients included."""
    cfg0 = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                               act_dtype="float32", zloss=0.0)
    cfg1 = dataclasses.replace(cfg0, loss_chunk=8)
    params = init_params(lm_spec(cfg0), 0, device=CPU)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg0.vocab, (B, 32),
                                                     dtype=np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg0.vocab, (B, 32),
                                                     dtype=np.int32))}
    l0, g0 = _grads(cfg0, params, batch)
    l1, g1 = _grads(cfg1, params, batch)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    for a, b in zip(_flat(g0), _flat(g1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


class _Largest(TorchDispatchMode):
    """The most elements of any tensor of three or more dimensions whose
    last is ``V`` that an op returns (logits, not the 2-D weights)."""

    def __init__(self, V: int):
        super().__init__()
        self.V = V
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dim() >= 3 \
                    and t.shape[-1] == self.V:
                self.most = max(self.most, t.numel())
        return out


def test_chunked_ce_never_builds_the_full_logits():
    """With loss_chunk set, no tensor of the forward or the backward holds
    B x S x V elements: the largest is one chunk's logits; and forward
    returns the post-norm hidden states in train mode."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              act_dtype="float32", loss_chunk=4,
                              vocab=4000, d_ff=64)
    params = init_params(lm_spec(cfg), 0, device=CPU)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    out = forward(params, cfg, tokens=batch["tokens"], mode="train",
                  device=CPU)
    assert out.logits.shape == (B, S, cfg.d_model)
    V = cfg.padded_vocab
    with _Largest(V) as mode:
        value_and_grad(params, cfg, batch, device=CPU)
    assert mode.most == B * cfg.loss_chunk * V < B * S * V, mode.most
    with _Largest(V) as dense:
        value_and_grad(params, dataclasses.replace(cfg, loss_chunk=0), batch,
                       device=CPU)
    assert dense.most >= B * S * V                # the check can see it


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-0.5b", dict(attn_chunk=4, loss_chunk=8)),
    ("gemma3-12b", dict(attn_chunk=8)),
    ("deepseek-v2-lite-16b", dict(attn_chunk=8)),
    ("recurrentgemma-2b", {}), ("mamba2-1.3b", {})])
def test_remat_changes_memory_not_values(arch, kw, monkeypatch):
    """Remat (a checkpoint per unit repeat) against no remat: loss and
    every gradient equal. Counted against a forward pass without grad: with
    remat the backward runs every block once more; the chunked attention's
    slabs are recomputed in either case (twice with remat, as the unit's
    recompute runs them again)."""
    from repro_torch.models import attention, transformer
    calls = {"block": 0, "slab": 0}

    def counted(fn, key):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(transformer, "block_apply",
                        counted(transformer.block_apply, "block"))
    monkeypatch.setattr(attention, "_sdpa", counted(attention._sdpa, "slab"))
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              act_dtype="float32", **kw)
    params = init_params(lm_spec(cfg), 0, device=CPU)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, rng).items()}

    def run(remat, grad=True):
        calls.update(block=0, slab=0)
        c = dataclasses.replace(cfg, remat=remat)
        if grad:
            out = _grads(c, params, batch)
        else:
            with torch.no_grad():
                out = loss_fn(params, c, batch, device=CPU)
        return out, dict(calls)
    _, fwd = run(True, grad=False)
    (l0, g0), plain = run(False)
    (l1, g1), remat = run(True)
    assert fwd["block"] == plain["block"] == cfg.n_layers
    assert remat["block"] == 2 * cfg.n_layers
    k = 2 if kw.get("attn_chunk") else 1    # chunked slabs recompute
    assert plain["slab"] == k * fwd["slab"]
    assert remat["slab"] == (k + 1) * fwd["slab"]
    assert float(l0) == float(l1)
    for a, b in zip(_flat(g0), _flat(g1)):
        assert torch.equal(a, b)
