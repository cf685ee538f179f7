"""Carry engine state and parameters across packages as numpy arrays.

The reference engine (JAX) and this port share the field names and dtypes
of ``SimState`` / ``Threads`` / ``Rows`` / ``Globals`` and of ``DynParams``
/ ``DynWorkload``. A state or parameter set turned into numpy on one side
(``jax.tree.map(np.asarray, x)`` there, :func:`state_to_numpy` here) comes
back on the other side through :func:`state_from_numpy` /
:func:`params_from_numpy`, so both engines can start from one state. The
objects passed in only need attributes with the right names, so nothing
here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve
from .engine import DynParams, Globals, Rows, SimState, Threads
from .workload import DynWorkload

_TABLES = ("zcdf", "acq_rank")


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)   # a writable copy


def state_from_numpy(s, device=None) -> SimState:
    """A state with numpy leaves (reference or port field names) -> tensors
    on ``device``."""
    dev = resolve(device)

    def conv(cls, obj):
        return cls(**{f: _tensor(getattr(obj, f), dev) for f in cls._fields})

    return SimState(conv(Threads, s.th), conv(Rows, s.rows),
                    conv(Globals, s.g))


def state_to_numpy(s: SimState) -> SimState:
    """Port state -> the same NamedTuples holding numpy arrays."""
    def conv(obj):
        return type(obj)(*(t.detach().cpu().numpy() for t in obj))

    return SimState(conv(s.th), conv(s.rows), conv(s.g))


def _host(v):
    """A numpy scalar -> the host type the port keeps for that field."""
    if np.asarray(v).dtype == np.bool_:
        return bool(v)
    if np.asarray(v).dtype.kind == "f":
        return float(np.float32(v))
    return int(v)


def params_from_numpy(dp, device=None) -> DynParams:
    """Reference ``DynParams`` with numpy leaves -> the port's params
    (host scalars, tables and ``txn_cap`` on ``device``)."""
    dev = resolve(device)
    wl = DynWorkload(**{
        f: (_tensor(getattr(dp.wl, f), dev) if f in _TABLES
            else _host(getattr(dp.wl, f)))
        for f in DynWorkload._fields})
    vals = {f: _host(getattr(dp, f)) for f in DynParams._fields
            if f not in ("txn_cap", "wl")}
    return DynParams(**vals, txn_cap=_tensor(dp.txn_cap, dev), wl=wl)


def params_to_numpy(dp: DynParams) -> DynParams:
    """Port params -> the same NamedTuples holding numpy values, with the
    reference's scalar dtypes (i32, f32, bool)."""
    def scalar(v):
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
