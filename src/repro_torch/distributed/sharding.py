"""Logical-axis sharding rules: the planning half of the reference's
``repro.distributed.sharding``.

Parameters carry logical axis names (see ``models/common.py``). The resolver
maps each logical axis to mesh axes by an ordered candidate list, enforcing
(a) divisibility of the dimension by the mesh-axis product and (b) no mesh
axis used twice within one tensor. Fallback is replication; every fallback
is recorded so a report can list degraded shardings.

Rule sets:
  * ``train``: FSDP+TP: width axes shard over "model"; depth axes ("embed",
    "vocab") also shard over "data" (+"pod").
  * ``train_dp``: replicated parameters, grads all-reduced once.
  * ``serve``: TP only: weights replicated over "data", sharded over
    "model".

A mesh here is a ``{axis name: size}`` mapping and a spec a tuple with one
entry a dimension: ``None``, an axis name, or a tuple of names (the
reference's ``PartitionSpec`` entries). Nothing executes a sharding yet: one
card runs a mesh of one device. The port's parameters and caches keep one
entry per layer where the reference stacks a leading "layers" axis (always
replicated), so the port's specs are the reference's without that axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

from ..models.common import tree_map_specs

Mesh = Mapping[str, int]
Spec = Tuple[object, ...]

# logical axis -> ordered candidates (each candidate = tuple of mesh axes)
RULES = {
    "train": {
        "embed": (("data",), ()),
        "mlp": (("model",), ()),
        "heads": (("model",), ()),
        "kv": (("model",), ()),
        "vocab": (("data", "model"), ("model",), ("data",), ()),
        "experts": (("model",), ()),
        "lru": (("model",), ()),
        "state": (("model",), ()),
        "layers": ((),),
    },
    "train_dp": {
        "embed": ((),),
        "mlp": (("model",), ()),
        "heads": (("model",), ()),
        "kv": (("model",), ()),
        "vocab": (("model",), ()),
        "experts": (("model",), ()),
        "lru": (("model",), ()),
        "state": (("model",), ()),
        "layers": ((),),
    },
    "serve": {
        "embed": ((),),
        # second candidate: when "model" is taken (expert axis), spread the
        # ff dim over "data"
        "mlp": (("model",), ("data",), ()),
        "heads": (("model",), ()),
        "kv": (("model",), ()),
        "vocab": (("model",), ()),
        "experts": (("model",), ()),
        "lru": (("model",), ()),
        "state": (("model",), ()),
        "layers": ((),),
    },
}


@dataclasses.dataclass
class ResolveReport:
    fallbacks: list = dataclasses.field(default_factory=list)

    def note(self, shape, axes, axis, wanted):
        self.fallbacks.append((tuple(shape), tuple(axes), axis, wanted))


def _axis_size(mesh: Mesh, names: Sequence[str]) -> int:
    return math.prod(mesh[n] for n in names) if names else 1


def resolve_spec(shape, axes, mesh: Mesh, rules,
                 report: Optional[ResolveReport] = None) -> Spec:
    """Resolve one tensor's logical axes to a spec."""
    used: set = set()
    out = []
    for dim, ax in zip(shape, axes):
        placed = None
        if ax is not None and ax in rules:
            for cand in rules[ax]:
                cand = tuple(c for c in cand if c in mesh)
                if any(c in used for c in cand):
                    continue
                if cand and dim % _axis_size(mesh, cand) == 0:
                    placed = cand
                    break
                if not cand:
                    placed = ()
                    break
            if placed is None:
                placed = ()
            if placed == () and rules[ax][0] != () and report is not None:
                report.note(shape, axes, ax, rules[ax][0])
        out.append(placed if placed else None)
        if placed:
            used.update(placed)
    # collapse single-axis tuples for readability
    return tuple(o[0] if (isinstance(o, tuple) and len(o) == 1) else o
                 for o in out)


def param_pspecs(specs, mesh: Mesh, mode: str = "train",
                 report: Optional[ResolveReport] = None):
    """A spec for every ``ParamSpec`` of a spec tree, in its shape."""
    rules = RULES[mode]
    return tree_map_specs(
        lambda s: resolve_spec(s.shape, s.axes, mesh, rules, report), specs)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """All data-parallel mesh axes ("pod" included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh)


def batch_pspec(mesh: Mesh, ndim: int, batch_dim: int = 0) -> Spec:
    spec: list = [None] * ndim
    spec[batch_dim] = data_axes(mesh)
    return tuple(spec)


# candidate "model"-axis dims per cache leaf, in preference order, counted
# in the reference's stacked layout (a leading layers axis); head_dim and
# latent dims are never sharded (they contract in attention)
_CACHE_PREF = {
    "k": (3, 2),      # (L, B, S, K, D): kv heads, else sequence
    "v": (3, 2),
    "ckv": (2,),      # (L, B, S, R): sequence only (latent contracts)
    "krope": (),      # tiny; replicate
    "h": (2,),        # rglru (L,B,W) width / ssd (L,B,H,P,N) heads
    "conv": (3,),     # (L, B, cw-1, C): channels
}


def cache_leaf_pspec(mesh: Mesh, name: str, leaf_shape) -> Spec:
    """The spec of one layer's cache field (``name``: the field's name) of
    shape ``leaf_shape``, batch first."""
    da = data_axes(mesh)
    dsz = _axis_size(mesh, da)
    msz = mesh.get("model", 1)
    nd = len(leaf_shape)
    spec: list = [None] * nd
    if leaf_shape[0] % max(dsz, 1) == 0 and dsz > 1:
        spec[0] = da                     # batch axis (replicate if B==1)
    for c in _CACHE_PREF.get(name, ()):
        i = c - 1                        # the port has no layers axis
        if i <= 0 or i >= nd:
            continue
        if leaf_shape[i] % msz == 0 and leaf_shape[i] >= msz:
            spec[i] = "model"
            break
    return tuple(spec)


def cache_pspecs(caches, mesh: Mesh):
    """Specs for the port's cache tree ``{g: {u: [cache per layer]}}``
    (``KVCache``, ``MLACache``, ``RGLRUState``, ``SSDState``), shaped as
    it, each cache a tuple of its fields' specs."""
    def layer(c):
        return type(c)(*(cache_leaf_pspec(mesh, name, tuple(t.shape))
                         for name, t in zip(c._fields, c)))
    return {g: {u: [layer(c) for c in layers] for u, layers in gt.items()}
            for g, gt in caches.items()}
