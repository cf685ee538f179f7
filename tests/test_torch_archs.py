"""Model-level port parity for the nine architectures beyond qwen2-0.5b, at
their smoke configs: prefill logits and caches and decode from both
packages' caches against the JAX reference on the same weights (carried
over with ``repro_torch.models.convert``) and the same numpy inputs; bf16
with the kernel path for deepseek-v2-lite and gemma3; the port alone
against its full forward and its dense attention; and the group-commit
server token for token against the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import (GroupServer as RefGroupServer,
                                Request as RefRequest)
from repro.models import (lm_spec as ref_lm_spec,
                          init_params as ref_init_params,
                          prefill as ref_prefill,
                          decode_step as ref_decode_step)
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import GroupServer, Request, serve_demo
from repro_torch.models import (lm_spec, init_params, forward, prefill,
                                decode_step, lm_init_cache)
from repro_torch.models.convert import (params_from_numpy, caches_from_numpy,
                                        caches_to_numpy)

NEW_ARCHS = [a for a in ARCHS if a != "qwen2-0.5b"]
TOKEN_ARCHS = [a for a in NEW_ARCHS if get_config(a).embed_inputs]
B, S = 2, 16
CPU = "cpu"

REF_PREFILL = jax.jit(ref_prefill, static_argnames=("cfg", "use_kernel",
                                                    "max_len"))
REF_DECODE = jax.jit(ref_decode_step, static_argnames=("cfg",))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw.setdefault("act_dtype", "float32")
    return (dataclasses.replace(get_config(arch, smoke=True), **kw),
            dataclasses.replace(ref_get_config(arch, smoke=True), **kw))


def _weights(cfg_ref, seed=1):
    """The reference's weights, as numpy, and the port's copy of them."""
    tree = jax.device_get(ref_init_params(ref_lm_spec(cfg_ref),
                                          jax.random.PRNGKey(seed)))
    return tree, params_from_numpy(tree, device=CPU)


def _inputs(cfg, seed, n):
    """numpy inputs of ``n`` positions: token ids or embeddings, and the
    M-RoPE streams (three distinct ones) where the config takes them."""
    rng = np.random.default_rng(seed)
    d = {}
    if cfg.embed_inputs:
        d["tokens"] = rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)
    else:
        d["embeds"] = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        d["positions3"] = np.sort(rng.integers(0, 3 * n, (3, B, n)),
                                  axis=-1).astype(np.int32)
    return d


def _cut(inputs, sl):
    return {k: (v[:, :, sl] if k == "positions3" else v[:, sl])
            for k, v in inputs.items()}


def _as(inputs, f):
    return {k: f(v) for k, v in inputs.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


def _caches_close(ref_caches, port_caches, tol):
    mine = caches_to_numpy(port_caches)
    assert [type(c).__name__ for g in ref_caches.values()
            for c in g.values()] == [type(c).__name__ for g in mine.values()
                                     for c in g.values()]
    xs, ys = jax.tree.leaves(ref_caches), jax.tree.leaves(mine)
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert x.shape == y.shape
        np.testing.assert_allclose(y, np.asarray(x, np.float32), rtol=tol,
                                   atol=tol)


# --------------------------------------------------------------- f32 parity

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """f32 prefill logits and caches, then a decode step from the
    reference's cache (carried over) and from the port's, within 2e-4. MoE
    runs at the default capacity factor, so the prefill drops tokens."""
    cfg, cfg_ref = _cfgs(arch)
    tree, params = _weights(cfg_ref)
    inp = _inputs(cfg, 2, S + 1)
    pre, dec = _cut(inp, slice(0, S)), _cut(inp, slice(S, S + 1))
    la, ca = REF_PREFILL(tree, cfg_ref, max_len=S + 1,
                         **_as(pre, jnp.asarray))
    lb, cb = prefill(params, cfg, max_len=S + 1, device=CPU,
                     **_as(pre, torch.from_numpy))
    assert lb.shape == la.shape
    assert _rel(la, lb) < 2e-4
    _caches_close(jax.device_get(ca), cb, 2e-4)
    la, ca2 = REF_DECODE(tree, cfg_ref, caches=ca,
                         pos=jnp.asarray(S, jnp.int32),
                         **_as(dec, jnp.asarray))
    for caches in (cb, caches_from_numpy(jax.device_get(ca), device=CPU)):
        lb, cb2 = decode_step(params, cfg, caches=caches, pos=S, device=CPU,
                              **_as(dec, torch.from_numpy))
        assert _rel(la, lb) < 2e-4
        _caches_close(jax.device_get(ca2), cb2, 2e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "gemma3-12b"])
def test_bf16_kernel_path_matches_reference(arch):
    """bf16 activations and caches through the kernel path (gemma3's global
    layers; MLA takes the plain path in both packages): the port's prefill
    and decode logits within 2e-2 of the reference's f32 logits on the same
    weights. (Against the reference's own bf16 run the distance is two
    independent bf16 roundings: on gemma3 each package's bf16 decode lies
    0.012-0.016 from f32, and the two 0.022 from each other.) The port's
    bf16 path lies no farther from f32 than the reference's does, within
    1.5x."""
    cfg, _ = _cfgs(arch, act_dtype="bfloat16")
    tree, params = _weights(_cfgs(arch)[1], seed=3)
    inp = _inputs(cfg, 4, S + 1)
    pre, dec = _cut(inp, slice(0, S)), _cut(inp, slice(S, S + 1))
    want, ref_bf16 = [], []
    for dt, out in (("float32", want), ("bfloat16", ref_bf16)):
        cfg_ref = _cfgs(arch, act_dtype=dt)[1]
        la, ca = REF_PREFILL(tree, cfg_ref, use_kernel=True, max_len=S + 1,
                             **_as(pre, jnp.asarray))
        ld, _ = REF_DECODE(tree, cfg_ref, caches=ca,
                           pos=jnp.asarray(S, jnp.int32),
                           **_as(dec, jnp.asarray))
        out += [la, ld]
    lb, cb = prefill(params, cfg, use_kernel=True, max_len=S + 1,
                     device=CPU, **_as(pre, torch.from_numpy))
    assert lb.dtype == cb["g0"]["u0"][0][0].dtype == torch.bfloat16
    ld, _ = decode_step(params, cfg, caches=cb, pos=S, device=CPU,
                        **_as(dec, torch.from_numpy))
    for got, f32, ref in zip((lb, ld), want, ref_bf16):
        err = _rel(f32, got.float())
        assert err < 2e-2
        assert err <= 1.5 * _rel(f32, ref)


# --------------------------------------------------------------- port alone

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_equals_full_forward(arch):
    """tests/test_decode_consistency.py's bar (2e-4 relative, f32) for the
    port alone: capacity factor 8 (no MoE drops), ssm_chunk 1 for mamba2's
    full forward over S + 1 positions; the kernel path on the CPU is the
    plain version, so no launch is counted. Decode keeps the caches'
    shapes and types."""
    cfg, _ = _cfgs(arch, capacity_factor=8.0)
    params = init_params(lm_spec(cfg), 1, device=CPU)
    inp = _as(_inputs(cfg, 5, S + 1), torch.from_numpy)
    cfg_f = dataclasses.replace(cfg, ssm_chunk=1) \
        if arch == "mamba2-1.3b" else cfg
    out = forward(params, cfg_f, mode="prefill", device=CPU, **inp)
    before = flash_attention.launches
    _, caches = prefill(params, cfg, use_kernel=True, max_len=S + 1,
                        device=CPU, **_cut(inp, slice(0, S)))
    assert flash_attention.launches == before
    logits, new = decode_step(params, cfg, caches=caches, pos=S, device=CPU,
                              **_cut(inp, slice(S, S + 1)))
    assert _rel(out.logits[:, -1], logits[:, 0]) < 2e-4
    assert out.aux_loss.dtype == torch.float32 and out.aux_loss.dim() == 0
    assert (float(out.aux_loss) > 0) == ("moe" in cfg.family)
    want = lm_init_cache(cfg, B, S + 1, dtype=torch.float32, device=CPU)
    for a, b, c in zip(jax.tree.leaves(caches), jax.tree.leaves(new),
                       jax.tree.leaves(want)):
        assert a.shape == b.shape == c.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "gemma3-12b",
                                  "deepseek-v2-lite-16b"])
def test_chunked_attention_matches_dense(arch):
    cfg, _ = _cfgs(arch, attn_chunk=8)
    params = init_params(lm_spec(cfg), 0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 32), dtype=np.int32))
    a = forward(params, cfg, tokens=toks, mode="train", device=CPU).logits
    b = forward(params, dataclasses.replace(cfg, attn_chunk=0), tokens=toks,
                mode="train", device=CPU).logits
    assert float((a - b).abs().max()) < 1e-4


def test_init_cache_types_match_reference():
    """Every cache type, its shapes and dtypes: attention caches take the
    requested dtype, RG-LRU and SSD states are always f32."""
    from repro.models.transformer import lm_init_cache as ref_init_cache
    for arch in NEW_ARCHS:
        cfg, cfg_ref = _cfgs(arch)
        mine = caches_to_numpy(lm_init_cache(cfg, 3, 20, device=CPU))
        ref = ref_init_cache(cfg_ref, 3, 20)
        xs, ys = jax.tree.leaves(ref), jax.tree.leaves(mine)
        assert [x.shape for x in xs] == [y.shape for y in ys], arch
        port = lm_init_cache(cfg, 3, 20, device=CPU)
        for g, gt in ref.items():
            for u, c in gt.items():
                layers = port[g][u]
                assert len(layers) == c[0].shape[0]
                assert type(layers[0]).__name__ == type(c).__name__
                for x, y in zip(c, layers[0]):
                    assert str(y.dtype) == f"torch.{x.dtype}", (arch, u)


# --------------------------------------------------------------- server

@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_group_server_matches_reference(arch):
    cfg, cfg_ref = _cfgs(arch)
    tree, params = _weights(cfg_ref, seed=0)
    ref = RefGroupServer(cfg_ref, tree, batch_slots=3, max_len=32)
    srv = GroupServer(cfg, params, batch_slots=3, max_len=32, device=CPU)
    rng = np.random.default_rng(0)
    mine, theirs = [], []
    for rid in range(5):
        prompt = rng.integers(0, cfg.vocab, 6, dtype=np.int32)
        theirs.append(RefRequest(rid=rid, prompt=prompt, max_new=2 + rid % 3))
        mine.append(Request(rid=rid, prompt=prompt, max_new=2 + rid % 3))
        ref.submit(theirs[-1])
        srv.submit(mine[-1])
    while ref.step():
        pass
    while srv.step():
        pass
    assert [r.out for r in mine] == [r.out for r in theirs]
    assert (srv.steps_fired, srv.members_served) == \
        (ref.steps_fired, ref.members_served)
    assert srv.pos == int(ref.pos)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_serve_demo_serves_every_token_arch(arch, capsys):
    """The reference's demo (12 prompts, 4..8 new tokens each, 4 slots) at
    each token-input architecture's smoke config: every request served."""
    srv = serve_demo(arch, n_requests=12, batch_slots=4, device=CPU)
    assert srv.members_served == sum(4 + rid % 5 for rid in range(12))
    assert not srv.queue and all(r is None for r in srv.active)
    assert "12 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-2b"])
def test_group_server_rejects_embedding_inputs(arch):
    cfg, _ = _cfgs(arch)
    params = init_params(lm_spec(cfg), 0, device=CPU)
    with pytest.raises(ValueError, match="embeds"):
        GroupServer(cfg, params, device=CPU)
