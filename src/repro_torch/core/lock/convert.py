"""Carry engine state and parameters across packages as numpy arrays.

The reference engine (JAX) and this port share the field names and dtypes
of ``SimState`` / ``Threads`` / ``Rows`` / ``Globals``, of ``DynParams`` /
``DynWorkload`` and of Aria's ``AriaState`` / ``AriaDyn``. A state or
parameter set turned into numpy on one side (``jax.tree.map(np.asarray,
x)`` there, :func:`state_to_numpy` / :func:`params_to_numpy` here) comes
back on the other side through :func:`state_from_numpy` /
:func:`params_from_numpy`, so both engines can start from one state. Packs
of G lanes (a leading axis on every leaf, as the reference's ``vmap``
entries take them) cross the same way. The objects passed in only need
attributes with the right names, so nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve
from .aria import AriaState
from .engine import DynParams, Globals, Rows, SimState, Threads
from .workload import DynWorkload

_TENSORS = ("zcdf", "acq_rank", "txn_cap")


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)   # a writable copy


def _conv(cls, obj, dev):
    return cls(**{f: _tensor(getattr(obj, f), dev) for f in cls._fields})


def state_from_numpy(s, device=None) -> SimState:
    """An engine state with numpy leaves (reference or port field names,
    one config or a pack) -> tensors on ``device``."""
    dev = resolve(device)
    return SimState(_conv(Threads, s.th, dev), _conv(Rows, s.rows, dev),
                    _conv(Globals, s.g, dev))


def aria_state_from_numpy(s, device=None) -> AriaState:
    """An Aria state with numpy leaves -> tensors on ``device``."""
    return _conv(AriaState, s, resolve(device))


def _leaves_to_numpy(obj):
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_leaves_to_numpy(v) for v in obj))
    return obj.detach().cpu().numpy()


def state_to_numpy(s):
    """Port state (engine or Aria, one config or a pack) -> the same
    NamedTuples holding numpy arrays."""
    return _leaves_to_numpy(s)


def _host(v):
    """A numpy scalar -> the host type the port keeps for that field."""
    if np.asarray(v).dtype == np.bool_:
        return bool(v)
    if np.asarray(v).dtype.kind == "f":
        return float(np.float32(v))
    return int(v)


def params_from_numpy(dp, device=None, cls=DynParams):
    """Reference ``DynParams`` (or ``AriaDyn`` with ``cls=AriaDyn``) with
    numpy leaves -> the port's params: tables and ``txn_cap`` on
    ``device``; scalars as host values for one config, or as numpy (G,)
    arrays for a pack of G lanes."""
    dev = resolve(device)
    batched = np.asarray(dp.wl.zcdf).ndim == 2

    def scalar(v):
        return np.array(v) if batched else _host(v)

    def conv(cls_, obj):
        return cls_(**{
            f: (conv(DynWorkload, getattr(obj, f)) if f == "wl"
                else _tensor(getattr(obj, f), dev) if f in _TENSORS
                else scalar(getattr(obj, f)))
            for f in cls_._fields})

    return conv(cls, dp)


def params_to_numpy(dp):
    """Port params (one config or a pack) -> the same NamedTuples holding
    numpy values, with the reference's scalar dtypes (i32, f32, bool)."""
    def scalar(v):
        if isinstance(v, np.ndarray):
            return v.copy()
        if isinstance(v, bool):
            return np.asarray(v)
        if isinstance(v, float):
            return np.asarray(v, np.float32)
        return np.asarray(v, np.int32)

    def conv(obj):
        return type(obj)(*(
            v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else conv(v) if isinstance(v, DynWorkload) else scalar(v)
            for v in obj))

    return conv(dp)

