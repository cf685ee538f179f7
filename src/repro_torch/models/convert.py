"""Carry model weights and decode caches across packages as numpy arrays.

The reference stacks each layer group's parameters and caches on a leading
"layers" axis (``lax.scan``); the port keeps a list with one entry per
layer. :func:`params_from_numpy` takes the reference's parameter tree as
numpy arrays (``jax.device_get(init_params(lm_spec(cfg), key))``) and
returns the port's (the 3-D codebook head and MoE's 3-D expert weights are
carried as they are); :func:`caches_from_numpy` does the same for a cache
tree of ``KVCache``, ``MLACache``, ``RGLRUState`` and ``SSDState`` leaves
and :func:`caches_to_numpy` goes back to the reference's stacked layout, so
both packages can run from, and be compared on, the same weights and caches.
:func:`opt_state_from_numpy` carries the reference's ``AdamWState`` (f32,
bf16 or 8-bit ``{"q", "s"}`` moments) across, and :func:`params_to_numpy`
stacks a port's parameter (or moment) tree back into the reference's
layout.
Only the objects' structure (a cache's class name and fields) is read, so
nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..optim.adamw import AdamWState
from .attention import KVCache, MLACache
from .rglru import RGLRUState
from .ssd import SSDState

# the port's cache classes, by the name they share with the reference's
CACHE_TYPES = {c.__name__: c for c in (KVCache, MLACache, RGLRUState,
                                       SSDState)}


def _tensor(a, dev, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: via float32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def _map(f, tree):
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    return f(tree)


def _unstack(tree, n: int) -> list:
    """A tree whose leaves have a leading axis of ``n`` -> ``n`` trees."""
    return [_map(lambda a: a[r], tree) for r in range(n)]


def _n_layers(unit_tree) -> int:
    """Length of the leading (stacked layers) axis of a unit's tree."""
    leaf = unit_tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(np.shape(leaf)[0])


def params_from_numpy(tree, device=None, dtype=None):
    """The reference's parameter tree (numpy leaves, stacked layer groups)
    -> the port's (tensors on ``device``, one dict per layer)."""
    dev = resolve(device)
    out = {k: _map(lambda a: _tensor(a, dev, dtype), v)
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {
        g: {u: [_map(lambda a: _tensor(a, dev, dtype), layer)
                for layer in _unstack(ut, _n_layers(ut))]
            for u, ut in gt.items()}
        for g, gt in tree["blocks"].items()}
    return out


def opt_state_from_numpy(state, device=None) -> AdamWState:
    """The reference's ``AdamWState(step, m, v)`` with numpy leaves (moments
    as f32, bf16, or ``{"q": int8, "s": f32}`` packs, stacked as the
    parameters are) -> the port's, on ``device``, every leaf at its own
    dtype."""
    dev = resolve(device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step=step, m=params_from_numpy(state.m, device=dev),
                      v=params_from_numpy(state.v, device=dev))


def _host(t) -> np.ndarray:
    """A tensor as numpy at its own dtype (bf16 widened to f32 exactly)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_to_numpy(tree):
    """The port's parameter tree (or a moment tree of the same shape) ->
    the reference's stacked layout with numpy leaves: each layer group's
    list of per-layer dicts becomes one dict of (L, ...) arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        layers = [params_to_numpy(x) for x in tree]
        return _map_many(lambda *xs: np.stack(xs), layers)
    return _host(tree)


def _map_many(f, trees):
    if isinstance(trees[0], dict):
        return {k: _map_many(f, [t[k] for t in trees]) for k in trees[0]}
    return f(*trees)


def caches_from_numpy(tree, device=None):
    """The reference's cache tree ``{g: {u: Cache(field=(L, B, ...), ...)}}``
    with numpy leaves (``Cache`` one of ``KVCache``, ``MLACache``,
    ``RGLRUState``, ``SSDState``) -> the port's ``{g: {u: [Cache]}}``."""
    dev = resolve(device)

    def layers(c):
        cls = CACHE_TYPES[type(c).__name__]
        n = np.shape(c[0])[0]
        return [cls(*(_tensor(f[r], dev) for f in c)) for r in range(n)]

    return {g: {u: layers(c) for u, c in gt.items()}
            for g, gt in tree.items()}


def caches_to_numpy(caches):
    """The port's cache tree -> the reference's stacked layout (the port's
    cache classes, one (L, ...) array a field), with numpy float32 leaves
    (bfloat16 widened exactly)."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    def stacked(layers):
        cls = type(layers[0])
        return cls(*(np.stack([host(c[i]) for c in layers])
                     for i in range(len(cls._fields))))

    return {g: {u: stacked(layers) for u, layers in gt.items()}
            for g, gt in caches.items()}
