"""Port parity for qwen2-0.5b serving: layers, GQA attention, prefill and
decode on ``qwen2_0_5b.SMOKE`` and the group-commit server, against the JAX
reference on the same weights (the reference's ``init_params`` output
carried over with ``repro_torch.models.convert``) and the same numpy
inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config, ARCHS as ref_archs
from repro.launch.serve import (GroupServer as RefGroupServer,
                                Request as RefRequest)
from repro.models import (lm_spec as ref_lm_spec,
                          init_params as ref_init_params,
                          count_params as ref_count_params,
                          prefill as ref_prefill,
                          decode_step as ref_decode_step)
from repro.models import layers as ref_layers
from repro.models.attention import (gqa_spec as ref_gqa_spec,
                                    gqa_attend as ref_gqa_attend)
from repro.models.common import init_params as ref_init_tree
from repro_torch.configs import get_config, ARCHS
from repro_torch.launch.serve import GroupServer, Request
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import (lm_spec, init_params, count_params,
                                forward, prefill, decode_step, tree_leaves)
from repro_torch.models import layers
from repro_torch.models.attention import gqa_attend, KVCache
from repro_torch.models.convert import (params_from_numpy,
                                        caches_from_numpy, caches_to_numpy)
from repro_torch.kernels.flash_attention import flash_attention

ARCH = "qwen2-0.5b"
B, S = 2, 24
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(act_dtype="float32"):
    return dataclasses.replace(get_config(ARCH, smoke=True),
                               act_dtype=act_dtype)


def _ref_cfg(act_dtype="float32"):
    return dataclasses.replace(ref_get_config(ARCH, smoke=True),
                               act_dtype=act_dtype)


def _weights(cfg_ref, seed=1):
    """The reference's weights, as numpy, and the port's copy of them."""
    tree = jax.device_get(ref_init_params(ref_lm_spec(cfg_ref),
                                          jax.random.PRNGKey(seed)))
    return tree, params_from_numpy(tree, device=CPU)


def _shapes(tree, path=""):
    """{key path: shape} of a nested dict/list tree of tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


# --------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    assert ARCHS == ref_archs
    for smoke in (False, True):
        assert get_config(arch, smoke).__dict__ == \
            ref_get_config(arch, smoke).__dict__
    full = get_config(arch)
    assert full.param_count() == ref_get_config(arch).param_count()
    assert count_params(lm_spec(full)) == ref_count_params(
        ref_lm_spec(ref_get_config(arch)))
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")
    if arch == ARCH:
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
                full.hd, full.d_ff, full.padded_vocab) == \
            (24, 896, 14, 2, 64, 4864, 152_064)


# --------------------------------------------------------------- init

def test_init_params_follows_the_reference_init():
    cfg = get_config(ARCH, smoke=True)
    a = init_params(lm_spec(cfg), 7, device=CPU)
    b = init_params(lm_spec(cfg), 7, device=CPU)
    ref = jax.device_get(ref_init_params(ref_lm_spec(ref_get_config(
        ARCH, smoke=True)), jax.random.PRNGKey(0)))
    conv = params_from_numpy(ref, device=CPU)
    assert _shapes(a) == _shapes(conv)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    blk = a["blocks"]["g0"]["u0"][0]
    assert torch.equal(blk["ln1"]["scale"], torch.ones(cfg.d_model))
    assert torch.equal(blk["attn"]["bq"], torch.zeros(cfg.n_heads * cfg.hd))
    # dense: normal * 1/sqrt(fan_in); embed: scale 1
    d = cfg.d_model
    w = torch.cat([lyr["mlp"]["wi_gate"].reshape(-1)
                   for lyr in a["blocks"]["g0"]["u0"]])
    assert abs(float(w.std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(a["embed"]["table"].std()) - 1) < 0.05
    assert float(a["head"]["w"].std()) * d ** 0.5 == pytest.approx(1, abs=.05)


# --------------------------------------------------------------- layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e6).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6)), rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(h), 1e-6).numpy(),
        np.asarray(ref_layers.rmsnorm({"scale": jnp.asarray(scale)},
                                      jnp.asarray(h), 1e-6)),
        rtol=1e-5, atol=1e-5)
    w = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in
         (("wi_gate", (64, 128)), ("wi_up", (64, 128)), ("wo", (128, 64)))}
    np.testing.assert_allclose(
        layers.mlp({k: torch.from_numpy(v) for k, v in w.items()},
                   torch.from_numpy(h)).numpy(),
        np.asarray(ref_layers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                                  jnp.asarray(h))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gqa_attend_prefill_and_decode_match_reference(use_kernel):
    cfg, cfg_ref = _cfg(), _ref_cfg()
    pj = jax.device_get(ref_init_tree(ref_gqa_spec(cfg_ref),
                                      jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    pj = {k: v + rng.normal(size=v.shape).astype(np.float32) * 0.1
          for k, v in pj.items()}         # nonzero biases
    pt = {k: torch.from_numpy(v) for k, v in pj.items()}
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    a, ca = ref_gqa_attend(pj, jnp.asarray(x), cfg_ref, "global", "prefill",
                           use_kernel=use_kernel, max_len=S + 4)
    b, cb = gqa_attend(pt, torch.from_numpy(x), cfg, "global", "prefill",
                       use_kernel=use_kernel, max_len=S + 4)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)
    for f in ("k", "v"):
        np.testing.assert_allclose(getattr(cb, f).numpy(), getattr(ca, f),
                                   rtol=1e-5, atol=1e-5)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    a, ca = ref_gqa_attend(pj, jnp.asarray(x1), cfg_ref, "global", "decode",
                           cache=ca, pos=jnp.asarray(S, jnp.int32))
    b, cb = gqa_attend(pt, torch.from_numpy(x1), cfg, "global", "decode",
                       cache=cb, pos=S)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cb.k.numpy(), ca.k, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- model

@pytest.mark.parametrize("act_dtype,use_kernel,tol", [
    ("float32", False, 2e-4), ("float32", True, 2e-4),
    ("bfloat16", True, 2e-2)])
def test_prefill_and_decode_match_reference(act_dtype, use_kernel, tol):
    cfg, cfg_ref = _cfg(act_dtype), _ref_cfg(act_dtype)
    tree, params = _weights(cfg_ref)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S + 1),
                                             dtype=np.int32)
    la, ca = ref_prefill(tree, cfg_ref, tokens=jnp.asarray(toks[:, :S]),
                         use_kernel=use_kernel, max_len=S + 1)
    lb, cb = prefill(params, cfg, tokens=torch.from_numpy(toks[:, :S]),
                     use_kernel=use_kernel, max_len=S + 1, device=CPU)
    assert lb.shape == la.shape == (B, 1, cfg.padded_vocab)
    assert _rel(la, lb.float()) < tol
    cb_np = caches_to_numpy(cb)
    for x, y in zip(jax.tree.leaves(ca), jax.tree.leaves(cb_np)):
        assert x.shape == y.shape
        np.testing.assert_allclose(y, np.asarray(x, np.float32), rtol=tol,
                                   atol=tol)
    # decode from the reference's cache, carried over, and from the port's
    la, ca2 = ref_decode_step(tree, cfg_ref, tokens=jnp.asarray(toks[:, S:]),
                              caches=ca, pos=jnp.asarray(S, jnp.int32))
    for caches in (cb, caches_from_numpy(jax.device_get(ca), device=CPU)):
        lb, cb2 = decode_step(params, cfg, tokens=torch.from_numpy(
            toks[:, S:]), caches=caches, pos=S, device=CPU)
        assert _rel(la, lb.float()) < tol
        for x, y in zip(jax.tree.leaves(ca2),
                        jax.tree.leaves(caches_to_numpy(cb2))):
            assert x.shape == y.shape
            np.testing.assert_allclose(y, np.asarray(x, np.float32),
                                       rtol=tol, atol=tol)


def test_prefill_then_decode_equals_full_forward():
    """tests/test_decode_consistency.py's bar (2e-4 relative, f32) for the
    port alone, through the kernel path: prefill step, then serve step."""
    cfg = _cfg()
    params = init_params(lm_spec(cfg), 1, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S + 1), dtype=np.int32))
    full = forward(params, cfg, tokens=toks, mode="prefill",
                   device=CPU).logits[:, -1]
    before = flash_attention.launches
    _, caches = make_prefill_step(cfg, use_kernel=True, max_len=S + 1,
                                  device=CPU)(params, {"tokens": toks[:, :S]})
    assert flash_attention.launches == before      # CPU: the plain version
    serve = make_serve_step(cfg, device=CPU)
    nxt, new = serve(params, {"tokens": toks[:, S:], "caches": caches,
                              "pos": S})
    logits, _ = decode_step(params, cfg, tokens=toks[:, S:], caches=caches,
                            pos=S, device=CPU)
    assert _rel(full, logits[:, 0]) < 2e-4
    assert nxt.dtype == torch.int32 and torch.equal(
        nxt, logits[:, -1].argmax(-1).to(torch.int32))
    for old, cur in zip(caches["g0"]["u0"], new["g0"]["u0"]):
        assert isinstance(cur, KVCache) and old.k.shape == cur.k.shape


# --------------------------------------------------------------- server

def test_group_server_matches_reference():
    cfg, cfg_ref = _cfg(), _ref_cfg()
    tree, params = _weights(cfg_ref, seed=0)
    ref = RefGroupServer(cfg_ref, tree, batch_slots=4)
    srv = GroupServer(cfg, params, batch_slots=4, device=CPU)
    rng = np.random.default_rng(0)
    mine, theirs = [], []
    for rid in range(9):
        prompt = rng.integers(0, cfg.vocab, 8, dtype=np.int32)
        theirs.append(RefRequest(rid=rid, prompt=prompt, max_new=3 + rid % 4))
        mine.append(Request(rid=rid, prompt=prompt, max_new=3 + rid % 4))
        ref.submit(theirs[-1])
        srv.submit(mine[-1])
    while ref.step():
        pass
    while srv.step():
        pass
    assert [r.out for r in mine] == [r.out for r in theirs]
    assert [r.order for r in mine] == [r.order for r in theirs]
    assert (srv.steps_fired, srv.members_served) == \
        (ref.steps_fired, ref.members_served)
    assert not srv.queue and all(r is None for r in srv.active)
    assert srv.pos == int(ref.pos)
