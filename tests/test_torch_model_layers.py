"""Layer-level port parity for every model family's serving path: M-RoPE,
sliding-window GQA (ring-buffer cache), the query-chunked attention, MLA
(prefill and absorbed decode), MoE (routing, capacity drops, combine),
RG-LRU, SSD and the codebook head, each against the JAX reference's
function on the same numpy inputs (1e-5 in f32), and gemma3's head dim 240
through the flash kernel's wrapper."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssd as ref_ssd
from repro.models.common import init_params as ref_init_tree
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention, route
from repro_torch.kernels.flash_attention.ops import check_shapes
from repro_torch.models import layers, attention, moe, rglru, ssd

TOL = 1e-5


def _jit(fn, *static):
    """The reference function jitted (one XLA program: far cheaper on the
    CPU than eager dispatch of each op), ``static`` names held static."""
    return jax.jit(fn, static_argnames=static)


_STATIC = ("cfg", "kind", "mode", "use_kernel", "max_len")
REF_GQA = _jit(ref_attention.gqa_attend, *_STATIC)
REF_MLA = _jit(ref_attention.mla_attend, "cfg", "mode", "max_len")
REF_MOE = _jit(ref_moe.moe, "cfg", "cap")
REF_RGLRU = _jit(ref_rglru.rglru, "cfg", "mode")
REF_SSD = _jit(ref_ssd.ssd, "cfg", "mode")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """The port's and the reference's smoke config, f32, with ``kw``."""
    kw.setdefault("act_dtype", "float32")
    return (dataclasses.replace(get_config(arch, smoke=True), **kw),
            dataclasses.replace(ref_get_config(arch, smoke=True), **kw))


def _weights(ref_spec, seed, jitter=0.0):
    """The reference's initialised weights for one layer spec, as numpy
    (``jitter`` adds noise so that zero biases and unit scales are not)."""
    tree = jax.device_get(ref_init_tree(ref_spec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def jit(a):
        a = np.asarray(a, np.float32)
        return a + rng.normal(size=a.shape).astype(np.float32) * jitter

    return jax.tree.map(jit, tree)


def _t(tree):
    """numpy tree -> torch tree (dicts of arrays)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32)
                               if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_tuple(got, want, tol=TOL):
    assert type(got).__name__ == type(want).__name__
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)


# --------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("D,S", [(16, 7), (128, 5), (48, 3)])
def test_apply_mrope_matches_reference(D, S):
    """hd 16 (the smoke config: sections scaled to (2, 3, 3)), 128 (qwen2-vl:
    (16, 24, 24)) and 48 (integer scaling leaves a slot at position 0)."""
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, S, 3, D)).astype(np.float32)
    p3 = rng.integers(0, 5000, (3, 2, S)).astype(np.int32)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6)
    _close(got, want)
    # equal streams are plain RoPE
    same = np.broadcast_to(p3[:1], p3.shape).copy()
    _close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                              1e6),
           layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]),
                             1e6))


# --------------------------------------------------------------- head

def test_codebook_unembed_matches_reference():
    cfg, cfg_ref = _cfgs("musicgen-medium")
    K = cfg.n_codebooks
    spec = layers.unembed_spec(cfg.d_model, cfg.padded_vocab, K)
    ref_spec = ref_layers.unembed_spec(cfg.d_model, cfg.padded_vocab, K)
    assert spec["w"].shape == ref_spec["w"].shape == (K, cfg.d_model,
                                                      cfg.padded_vocab)
    assert spec["w"].fan_in_axes == ref_spec["w"].fan_in_axes == (1,)
    w = _weights(ref_spec, 5)
    x = np.random.default_rng(5).normal(size=(2, 3, cfg.d_model)).astype(
        np.float32)
    got = layers.unembed(_t(w), torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, K, cfg.padded_vocab)
    _close(got, ref_layers.unembed(_j(w), jnp.asarray(x)))
    one = _weights(ref_layers.unembed_spec(cfg.d_model, 32), 6)
    _close(layers.unembed(_t(one), torch.from_numpy(x)),
           ref_layers.unembed(_j(one), jnp.asarray(x)))


# --------------------------------------------------------------- local GQA

@pytest.mark.parametrize("S,max_len", [(24, 28), (24, 12), (10, 40)])
def test_local_gqa_prefill_and_decode_match_reference(S, max_len):
    """gemma3's smoke window is 16: S = 24 wraps the ring (prefill rolls by
    S % window); a capacity below the window keeps fewer slots; S = 10
    fills only part of it. Five decode steps walk the ring past a wrap."""
    cfg, cfg_ref = _cfgs("gemma3-12b")
    assert cfg.window == 16
    w = _weights(ref_attention.gqa_spec(cfg_ref), 3, jitter=0.1)
    rng = np.random.default_rng(S + max_len)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    for use_kernel in (False, True):
        before = flash_attention.launches
        b, cb = attention.gqa_attend(_t(w), torch.from_numpy(x), cfg,
                                     "local", "prefill",
                                     use_kernel=use_kernel, max_len=max_len)
        assert flash_attention.launches == before   # local: the plain path
        a, ca = REF_GQA(_j(w), jnp.asarray(x), cfg_ref,
                                         "local", "prefill",
                                         use_kernel=use_kernel,
                                         max_len=max_len)
        _close(b, a)
        _close_tuple(cb, ca)
    assert cb.k.shape[1] == attention.gqa_cache_len(cfg, "local", max_len) \
        == ref_attention.gqa_cache_len(cfg_ref, "local", max_len)
    for i in range(5):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        b, cb = attention.gqa_attend(_t(w), torch.from_numpy(x1), cfg,
                                     "local", "decode", cache=cb, pos=S + i)
        a, ca = REF_GQA(_j(w), jnp.asarray(x1), cfg_ref,
                                         "local", "decode", cache=ca,
                                         pos=jnp.asarray(S + i, jnp.int32))
        _close(b, a)
        _close_tuple(cb, ca)


@pytest.mark.parametrize("window,Sk", [(None, 32), (16, 32), (5, 24)])
def test_sdpa_chunked_matches_reference(window, Sk):
    rng = np.random.default_rng(Sk)
    q = rng.normal(size=(2, Sk, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, Sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, Sk, 2, 12)).astype(np.float32)
    got = attention._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), 0.25,
                                  window, 8)
    want = ref_attention._sdpa_chunked(*map(jnp.asarray, (q, k, v)), 0.25,
                                       window, 8)
    _close(got, want)
    mask = attention._causal_mask(Sk, Sk, window)[None, None]
    _close(got, attention._sdpa(*map(torch.from_numpy, (q, k, v)), mask,
                                0.25))
    np.testing.assert_array_equal(
        attention._causal_mask(8, Sk, window, offset=8).numpy(),
        np.asarray(ref_attention._causal_mask(8, Sk, window, offset=8)))


@pytest.mark.parametrize("mrope", [False, True])
def test_gqa_mrope_prefill_and_decode_match_reference(mrope):
    cfg, cfg_ref = _cfgs("qwen2-vl-2b")
    w = _weights(ref_attention.gqa_spec(cfg_ref), 4, jitter=0.1)
    rng = np.random.default_rng(4)
    S = 12
    x = rng.normal(size=(2, S + 1, cfg.d_model)).astype(np.float32)
    p3 = rng.integers(0, 40, (3, 2, S + 1)).astype(np.int32) if mrope \
        else None
    kw = lambda sl, f: {} if p3 is None else {"positions3": f(p3[:, :, sl])}
    b, cb = attention.gqa_attend(_t(w), torch.from_numpy(x[:, :S]), cfg,
                                 "global", "prefill", max_len=S + 1,
                                 **kw(slice(0, S), torch.from_numpy))
    a, ca = REF_GQA(_j(w), jnp.asarray(x[:, :S]), cfg_ref,
                                     "global", "prefill", max_len=S + 1,
                                     **kw(slice(0, S), jnp.asarray))
    _close(b, a)
    _close_tuple(cb, ca)
    b, cb = attention.gqa_attend(_t(w), torch.from_numpy(x[:, S:]), cfg,
                                 "global", "decode", cache=cb, pos=S,
                                 **kw(slice(S, S + 1), torch.from_numpy))
    a, ca = REF_GQA(_j(w), jnp.asarray(x[:, S:]), cfg_ref,
                                     "global", "decode", cache=ca,
                                     pos=jnp.asarray(S, jnp.int32),
                                     **kw(slice(S, S + 1), jnp.asarray))
    _close(b, a)
    _close_tuple(cb, ca)


# --------------------------------------------------------------- gemma3 D=240

def test_gemma3_head_dim_240_takes_the_fma_and_wgmma_kernels():
    """gemma3-12b's global layers (head dim 240) with ``use_kernel`` equal
    the reference's (its Pallas kernel in interpret mode); on the card the
    wrapper sends f32 inputs to the 3xTF32 kernel and bf16 ones to the
    wgmma kernel, which both have a D = 240 instance (the FMA kernel, now
    retired, took f32 here before the 3xTF32 kernel had one); bf16 takes
    the wgmma kernel at every head dim."""
    cfg, cfg_ref = _cfgs("gemma3-12b", head_dim=240, n_heads=4, n_kv_heads=2,
                         d_model=64)
    w = _weights(ref_attention.gqa_spec(cfg_ref), 9, jitter=0.05)
    x = np.random.default_rng(9).normal(size=(1, 40, 64)).astype(np.float32)
    before = flash_attention.launches
    b, _ = attention.gqa_attend(_t(w), torch.from_numpy(x), cfg, "global",
                                "prefill", use_kernel=True)
    assert flash_attention.launches == before      # CPU: the plain version
    a, _ = REF_GQA(_j(w), jnp.asarray(x), cfg_ref, "global",
                                    "prefill", use_kernel=True)
    _close(b, a)
    q = torch.zeros((1, 40, 4, 240), dtype=torch.bfloat16)
    kv = torch.zeros((1, 40, 2, 240), dtype=torch.bfloat16)
    assert route(q, kv, kv) == "wgmma" and route(q.float(), kv.float(),
                                                 kv.float()) == "tf32x3"
    check_shapes(q, kv, kv)


# --------------------------------------------------------------- MLA

@pytest.mark.parametrize("attn_chunk", [0, 8])
def test_mla_prefill_and_absorbed_decode_match_reference(attn_chunk):
    cfg, cfg_ref = _cfgs("deepseek-v2-lite-16b", attn_chunk=attn_chunk)
    w = _weights(ref_attention.mla_spec(cfg_ref), 7, jitter=0.1)
    rng = np.random.default_rng(7)
    S = 16
    x = rng.normal(size=(2, S + 3, cfg.d_model)).astype(np.float32)
    b, cb = attention.mla_attend(_t(w), torch.from_numpy(x[:, :S]), cfg,
                                 "prefill", max_len=S + 3)
    a, ca = REF_MLA(_j(w), jnp.asarray(x[:, :S]), cfg_ref,
                                     "prefill", max_len=S + 3)
    _close(b, a)
    _close_tuple(cb, ca)
    assert cb.ckv.shape == (2, S + 3, cfg.kv_lora_rank)
    for i in range(3):
        xi = x[:, S + i:S + i + 1]
        b, cb = attention.mla_attend(_t(w), torch.from_numpy(xi), cfg,
                                     "decode", cache=cb, pos=S + i)
        a, ca = REF_MLA(_j(w), jnp.asarray(xi), cfg_ref,
                                         "decode", cache=ca,
                                         pos=jnp.asarray(S + i, jnp.int32))
        _close(b, a)
        _close_tuple(cb, ca)
    # the absorbed decode equals the expanded attention of the full prefix
    full, _ = attention.mla_attend(_t(w), torch.from_numpy(x),
                                   dataclasses.replace(cfg, attn_chunk=0),
                                   "train")
    _close(b[:, 0], full[:, -1], 1e-4)


# --------------------------------------------------------------- MoE

@pytest.mark.parametrize("arch,cf,shards", [
    ("deepseek-v2-lite-16b", 8.0, 1),      # no drops
    ("deepseek-v2-lite-16b", 1.25, 1),     # the default: tokens drop
    ("arctic-480b", 1.25, 1),              # no shared expert
    ("deepseek-v2-lite-16b", 1.25, 2),     # capacity per data shard
])
def test_moe_matches_reference(arch, cf, shards):
    cfg, cfg_ref = _cfgs(arch, capacity_factor=cf, moe_data_shards=shards)
    w = _weights(ref_moe.moe_spec(cfg_ref), 11)
    x = np.random.default_rng(11).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    y, st = moe.moe(_t(w), torch.from_numpy(x), cfg)
    y_ref, st_ref = REF_MOE(_j(w), jnp.asarray(x), cfg_ref)
    _close(y, y_ref)
    np.testing.assert_array_equal(st.expert_counts.numpy(),
                                  np.asarray(st_ref.expert_counts))
    assert st.expert_counts.dtype == torch.int32
    assert int(st.dropped) == int(st_ref.dropped)
    assert (int(st.dropped) > 0) == (cf == 1.25)
    _close(st.aux_loss, st_ref.aux_loss)
    assert int(st.expert_counts.sum()) == 2 * 24 * cfg.top_k


def test_moe_capacity_helpers_match_reference():
    for t, k, e, cf in [(48, 2, 8, 1.25), (4096, 6, 64, 1.25), (4, 6, 64, 1.0),
                        (1000, 2, 128, 8.0)]:
        assert moe.capacity(t, k, e, cf) == ref_moe.capacity(t, k, e, cf)
        assert moe.capacity(t, k, e, cf) % 8 == 0
    ema = np.array([3.5, 17.25, 0.0], np.float32)
    assert moe.suggest_capacity(torch.from_numpy(ema), 2) == \
        ref_moe.suggest_capacity(jnp.asarray(ema), 2)
    cfg, cfg_ref = _cfgs("deepseek-v2-lite-16b")
    w = _weights(ref_moe.moe_spec(cfg_ref), 12)
    x = np.random.default_rng(12).normal(size=(1, 16, cfg.d_model)).astype(
        np.float32)
    y, st = moe.moe(_t(w), torch.from_numpy(x), cfg, cap=4)
    y_ref, st_ref = REF_MOE(_j(w), jnp.asarray(x), cfg_ref, cap=4)
    _close(y, y_ref)
    assert int(st.dropped) == int(st_ref.dropped) > 0


# --------------------------------------------------------------- RG-LRU

@pytest.mark.parametrize("S", [1, 13, 32])
def test_rglru_prefill_and_decode_match_reference(S):
    cfg, cfg_ref = _cfgs("recurrentgemma-2b")
    w = _weights(ref_rglru.rglru_spec(cfg_ref), 13, jitter=0.1)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S + 2, cfg.d_model)).astype(np.float32)
    b, sb = rglru.rglru(_t(w), torch.from_numpy(x[:, :S]), cfg, "prefill")
    a, sa = REF_RGLRU(_j(w), jnp.asarray(x[:, :S]), cfg_ref,
                            "prefill")
    _close(b, a)
    _close_tuple(sb, sa)
    assert sb.h.dtype == sb.conv.dtype == torch.float32
    for i in range(2):
        xi = x[:, S + i:S + i + 1]
        b, sb = rglru.rglru(_t(w), torch.from_numpy(xi), cfg, "decode",
                            state=sb)
        a, sa = REF_RGLRU(_j(w), jnp.asarray(xi), cfg_ref, "decode",
                                state=sa)
        _close(b, a)
        _close_tuple(sb, sa)


def test_rglru_log_depth_scan_equals_the_recurrence():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.1, 1.0, (2, 37, 5)))
    b = torch.from_numpy(rng.normal(size=(2, 37, 5)))
    h, want = torch.zeros((2, 5), dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru._linear_scan(a, b),
                               torch.stack(want, 1), rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------- SSD

@pytest.mark.parametrize("S,chunk", [(24, 8), (16, 16), (8, 1)])
def test_ssd_prefill_and_decode_match_reference(S, chunk):
    cfg, cfg_ref = _cfgs("mamba2-1.3b", ssm_chunk=chunk)
    w = _weights(ref_ssd.ssd_spec(cfg_ref), 17, jitter=0.1)
    rng = np.random.default_rng(S + chunk)
    x = rng.normal(size=(2, S + 2, cfg.d_model)).astype(np.float32)
    b, sb = ssd.ssd(_t(w), torch.from_numpy(x[:, :S]), cfg, "prefill")
    a, sa = REF_SSD(_j(w), jnp.asarray(x[:, :S]), cfg_ref, "prefill")
    _close(b, a)
    _close_tuple(sb, sa)
    assert sb.h.dtype == sb.conv.dtype == torch.float32
    for i in range(2):
        xi = x[:, S + i:S + i + 1]
        b, sb = ssd.ssd(_t(w), torch.from_numpy(xi), cfg, "decode", state=sb)
        a, sa = REF_SSD(_j(w), jnp.asarray(xi), cfg_ref, "decode",
                            state=sa)
        _close(b, a)
        _close_tuple(sb, sa)


def test_ssd_segsum_matches_reference():
    a = np.random.default_rng(1).normal(size=(2, 3, 6)).astype(np.float32)
    got = ssd._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(ref_ssd._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)
    assert np.isneginf(got[..., 0, 1]).all() and (got[..., 2, 2] == 0).all()


# --------------------------------------------------------------- caches

def _cache_structure(tree):
    """{g: {u: (type name, [(shape, dtype name), ...])}} of a cache tree
    (meta tensors or ShapeDtypeStructs)."""
    return {g: {u: (type(c).__name__,
                    [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                     for x in c])
                for u, c in units.items()}
            for g, units in tree.items()}


def _all_archs():
    from repro_torch.configs import ARCHS
    return ARCHS


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", _all_archs())
def test_lm_cache_shapes_equal_the_reference(arch, smoke):
    """``lm_cache_shapes`` (meta tensors) against the reference's
    ShapeDtypeStructs for all ten configs, smoke and full width: the same
    keys, cache types, shapes and dtypes, each leaf stacked over its
    group's repeats; ``block_cache_shape`` is one repeat of it, and
    ``lm_init_cache`` allocates exactly those shapes."""
    from repro.models import lm_cache_shapes as ref_shapes
    from repro.models.transformer import block_cache_shape as ref_block
    from repro_torch.models import lm_cache_shapes, lm_init_cache
    from repro_torch.models.transformer import block_cache_shape
    cfg, cfg_ref = get_config(arch, smoke=smoke), ref_get_config(arch,
                                                                 smoke=smoke)
    B, S = 3, 40
    for dt, ref_dt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        got = lm_cache_shapes(cfg, B, S, dt)
        assert _cache_structure(got) == _cache_structure(
            ref_shapes(cfg_ref, B, S, ref_dt)), (arch, dt)
        assert all(x.is_meta for units in got.values()
                   for c in units.values() for x in c)
        for kind in {k for unit, _ in cfg.layout for k in unit}:
            one = block_cache_shape(cfg, kind, B, S, dt)
            want = ref_block(cfg_ref, kind, B, S, ref_dt)
            assert _cache_structure({"g": {"u": one}}) == \
                _cache_structure({"g": {"u": want}}), (arch, kind)
    if smoke:
        caches = lm_init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
        want = lm_cache_shapes(cfg, B, S, torch.float32)
        for g, units in want.items():
            for u, c in units.items():
                assert len(caches[g][u]) == c[0].shape[0]
                for layer in caches[g][u]:
                    assert [(tuple(y.shape), y.dtype) for y in layer] == [
                        (tuple(x.shape[1:]), x.dtype) for x in c]
                    assert all(not y.any() for y in layer)
