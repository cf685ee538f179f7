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

Two halves. The planning half takes a mesh as a ``{axis name: size}``
mapping and gives a spec a tensor: a tuple with one entry a dimension,
``None``, an axis name, or a tuple of names (the reference's
``PartitionSpec`` entries). The port's parameters and caches keep one entry
per layer where the reference stacks a leading "layers" axis (always
replicated), so the port's specs are the reference's without that axis.

The placement half executes them on DTensor, over a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (:func:`repro_torch.launch.mesh.make_host_mesh`): a spec becomes one
``Shard(dim)`` or ``Replicate()`` a mesh axis (:class:`Sharding`, the
reference's ``NamedSharding``), :func:`distribute` places a tree by a tree
of them, and :func:`annotate` redistributes an activation under the mesh a
launcher installed (:func:`set_activation_mesh`), the reference's
``with_sharding_constraint``. Ops between sharded tensors then run as
DTensor dispatches them, with the collectives it inserts (as XLA's SPMD
partitioner does for the reference).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

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
    # imported here: the models import this module for annotate
    from ..models.common import tree_map_specs
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


# ---------------------------------------------------------------------------
# placement on DTensor
# ---------------------------------------------------------------------------

def _mesh_dict(mesh) -> Mesh:
    """A ``DeviceMesh`` as the planning half's ``{axis name: size}``."""
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: Spec, axis_names: Sequence[str]) -> tuple:
    """A spec as one placement a mesh axis (``axis_names`` in the mesh's
    order): ``Shard(d)`` on the axes that tensor dimension ``d`` names,
    ``Replicate()`` on the rest. A dimension over several axes names them
    in the mesh's order, major first, as DTensor shards them."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = [axis_names.index(n) for n in names if n in axis_names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dimension {d} names mesh axes "
                             f"out of the mesh's order {tuple(axis_names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class Sharding(NamedTuple):
    """A tensor's placement on a ``DeviceMesh``: the reference's
    ``NamedSharding`` (``spec`` its ``PartitionSpec``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh.mesh_dim_names)

    def place(self, x):
        """``x`` (the whole tensor, the same on every rank) as a DTensor
        of this placement; each rank keeps its own shard, no data moves.
        A DTensor is redistributed."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements)
        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


def param_shardings(specs, mesh, mode: str = "train",
                    report: Optional[ResolveReport] = None):
    """A :class:`Sharding` for every ``ParamSpec`` of a spec tree."""
    from ..models.common import tree_map_specs
    return tree_map_specs(lambda s: Sharding(mesh, s),
                          param_pspecs(specs, _mesh_dict(mesh), mode,
                                       report))


def batch_shardings(tree, mesh, batch_dims=None):
    """Shard the batch dim of every tensor of a batch dict over the data
    axes; ``batch_dims`` maps a key to its batch dim where it is not 0
    (``positions3`` (3, B, S): 1). A batch the data axes do not divide is
    replicated."""
    batch_dims = batch_dims or {}

    def f(key, leaf):
        if isinstance(leaf, dict):
            return {k: f(k, v) for k, v in leaf.items()}
        return _batch_sharding(mesh, leaf.shape, batch_dims.get(key, 0))
    return {k: f(k, v) for k, v in tree.items()}


def _batch_sharding(mesh, shape, batch_dim: int) -> Sharding:
    m = _mesh_dict(mesh)
    dsz = _axis_size(m, data_axes(m))
    if dsz <= 1 or shape[batch_dim] % dsz:
        # one data rank, or a tiny batch: whole (torch 2.13's DTensor
        # cannot flatten a batch of 1 that is "sharded" over one rank)
        return Sharding(mesh, (None,) * len(shape))
    return Sharding(mesh, batch_pspec(m, len(shape), batch_dim))


def cache_shardings(caches, mesh):
    """A :class:`Sharding` for every field of the port's cache tree
    (:func:`cache_pspecs`), shaped as it."""
    specs = cache_pspecs(caches, _mesh_dict(mesh))
    return {g: {u: [type(c)(*(Sharding(mesh, s) for s in c))
                    for c in layers] for u, layers in gt.items()}
            for g, gt in specs.items()}


def scalar_sharding(mesh) -> Sharding:
    return Sharding(mesh, ())


def distribute(tree, shardings):
    """``tree`` (dicts, lists, NamedTuples of tensors) placed by a tree of
    :class:`Sharding` of the same structure."""
    if isinstance(shardings, Sharding):
        return shardings.place(tree)
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, s)
                            for v, s in zip(tree, shardings)))
    return type(tree)(distribute(v, s) for v, s in zip(tree, shardings))


# ---------------------------------------------------------------------------
# activation annotations (set by launchers; identity without a mesh)
# ---------------------------------------------------------------------------

_ACT_MESH: list = [None]


def set_activation_mesh(mesh) -> None:
    """Launchers install their ``DeviceMesh`` here so model code can
    annotate activations; model code stays mesh-agnostic, and without a
    mesh (every one-device run) :func:`annotate` is the identity."""
    _ACT_MESH[0] = mesh


@contextlib.contextmanager
def on_mesh(mesh):
    """Run model code on ``mesh``: :func:`annotate` redistributes under it,
    and a plain tensor that meets a DTensor in an op (masks, positions,
    constants the model makes) counts as replicated. Restores the previous
    activation mesh on exit. ``mesh`` None: nothing changes."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _ACT_MESH[0]
    _ACT_MESH[0] = mesh
    try:
        with implicit_replication():
            yield
    finally:
        _ACT_MESH[0] = prev


def place_batch(x, batch_dim: int = 0):
    """Under an installed mesh, a plain tensor of model inputs (the same on
    every rank) as a DTensor sharded over the data axes along
    ``batch_dim`` (replicated where they do not divide it); otherwise ``x``
    as it is. Token ids must be placed before the embedding of a sharded
    table: DTensor masks the rows each rank lacks with a buffer shaped as
    the ids."""
    mesh = _ACT_MESH[0]
    if mesh is None or not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x
    return _batch_sharding(mesh, x.shape, batch_dim).place(x)


def unshard_dim(x, dim: int):
    """A DTensor ``x`` with dimension ``dim`` whole on every rank (its other
    placements kept); any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def annotate(x, *dims):
    """Redistribute activation ``x``: dims is "batch" | "model" | None per
    axis (the data axes, the model axis, replicated), each kept only where
    the axis divides the dimension (the data axes also only where they hold
    more than one rank). The residual stream is annotated ("batch",
    "model", None): sequence-parallel between blocks, where the model axis
    divides the sequence (:func:`seq_gather`, :func:`seq_scatter`). The
    identity unless a launcher installed a mesh and ``x`` is a DTensor."""
    mesh = _ACT_MESH[0]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    m = _mesh_dict(mesh)
    spec = []
    for d, size in zip(dims, x.shape):
        if d == "batch":
            da = data_axes(m)
            ok = _axis_size(m, da) > 1 and size % _axis_size(m, da) == 0
            spec.append(da if ok else None)
        elif d == "model":
            ok = "model" in m and size % m["model"] == 0
            spec.append("model" if ok else None)
        else:
            spec.append(None)
    spec += [None] * (x.dim() - len(spec))
    return x.redistribute(mesh, placements(tuple(spec),
                                           mesh.mesh_dim_names))


def _seq_placements(x):
    """``x``'s placements with its sequence shard over "model" made
    ``Replicate``, or None where ``x`` is no DTensor sharded over "model"
    along dimension 1."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor) or "model" not in (
            x.device_mesh.mesh_dim_names or ()):
        return None
    i = x.device_mesh.mesh_dim_names.index("model")
    if x.placements[i] != Shard(1):
        return None
    return x.placements[:i] + (Replicate(),) + x.placements[i + 1:]


def seq_gather(h):
    """A residual-shaped DTensor ``h`` (B, S, ...) sharded over "model"
    along the sequence, whole along it on every rank of that axis (an
    all-gather; its batch sharding over the data axes kept), so that a
    mixer or MLP sees whole rows. Its backward is a reduce-scatter (the
    gradient of a column-parallel product is partial over "model"). Any
    other tensor as it is: off a mesh, and where :func:`annotate` kept the
    sequence whole (decode's S = 1, a length the model axis does not
    divide). Megatron's sequence parallelism, which the reference gets
    from XLA's partitioner."""
    pl = _seq_placements(h)
    return h if pl is None else h.redistribute(h.device_mesh, pl)


def seq_scatter(y, like):
    """A block's output ``y`` placed as the residual ``like`` where
    ``like`` is sharded over "model" along the sequence: a reduce-scatter
    of the partial sums of a row-parallel product, a local slice of an
    output replicated over "model" (the MoE layer's). Its backward is an
    all-gather. ``y`` as it is wherever :func:`seq_gather` is the
    identity."""
    if _seq_placements(like) is None:
        return y
    return y.redistribute(like.device_mesh, like.placements)


def reduce_partial(x):
    """A DTensor ``x`` with its partial sums reduced (each ``Partial``
    placement made ``Replicate``); any other tensor as it is. A row-parallel
    product comes out partial, and torch 2.11's DTensor cannot add a
    sharded bias to it."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    computation's gradients can come back transposed, and DTensor's
    backward of the projections views them as rows."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def shard_local(fn, args, dims, out_dims):
    """``fn(*args)`` on each rank's shards when ``args`` hold DTensors (a
    mesh), else as it is. ``dims[i]`` is ``(batch dim, model dim)`` of
    argument i (None: whole): each DTensor argument is placed with its
    batch dim over the data axes and its model dim over "model", ``fn``
    runs on the local tensors (other arguments pass as they are), and its
    output, a tensor or a tuple, comes back as DTensors placed alike by
    ``out_dims``. An axis splits only where it holds more than one rank and
    divides every dimension named for it, else it keeps them whole (never
    a forced split). ``fn``
    must compute each output shard from the same shards of its inputs (the
    rows of a batch, the heads of attention or of an SSM). Autograd runs
    through ``to_local`` and ``from_local``; the gradients of the local
    inputs are made contiguous. An argument kept whole on an axis that
    splits the outputs (the B and C of SSD over the heads' ranks, its A
    over the batch's) takes only its rank's share of the gradient there:
    that gradient is declared ``Partial`` on the axis, so it is summed
    over the ranks before it reaches a parameter. Ops whose sharding rule
    differs between torch versions run here on plain tensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    placed = [(a, d) for a, d in zip(args, dims) if isinstance(a, DTensor)]
    if not placed:
        return fn(*args)
    mesh = placed[0][0].device_mesh
    sizes = _mesh_dict(mesh)
    da = data_axes(sizes)
    dsz = _axis_size(sizes, da)
    msz = sizes.get("model", 1)
    split_data = dsz > 1 and all(bd is None or a.shape[bd] % dsz == 0
                                 for a, (bd, _) in placed)
    split_model = msz > 1 and all(md is None or a.shape[md] % msz == 0
                                  for a, (_, md) in placed)

    def pl(bd, md):
        return tuple(
            Shard(bd) if n in da and split_data and bd is not None else
            Shard(md) if n == "model" and split_model and md is not None
            else Replicate() for n in mesh.mesh_dim_names)
    outs = out_dims if isinstance(out_dims[0], tuple) else (out_dims,)
    split = [any(p.is_shard() for p in ps)
             for ps in zip(*(pl(*d) for d in outs))]

    def on_rank(a, d):
        fwd = pl(*d)
        grad = tuple(Partial() if s and p.is_replicate() else p
                     for s, p in zip(split, fwd))
        return _ContiguousGrad.apply(a.redistribute(mesh, fwd).to_local(
            grad_placements=grad))
    local = [on_rank(a, d) if isinstance(a, DTensor) else a
             for a, d in zip(args, dims)]
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(t, mesh, pl(*d), run_check=False)
                     for t, d in zip(out, out_dims))
    return DTensor.from_local(out, mesh, pl(*out_dims), run_check=False)
