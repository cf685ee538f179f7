"""Carry engine state and parameters across packages as numpy arrays.

The reference engine (JAX) and this port share the field names and dtypes
of ``SimState`` / ``Threads`` / ``Rows`` / ``Globals``, of ``DynParams`` /
``DynWorkload`` and of Aria's ``AriaState`` / ``AriaDyn``. A state or
parameter set turned into numpy on one side (``jax.tree.map(np.asarray,
x)`` there, :func:`state_to_numpy` / :func:`params_to_numpy` here) comes
back on the other side through :func:`state_from_numpy` /
:func:`params_from_numpy`, so both engines can start from one state. An
event buffer (``TraceBuf``) crosses the same way through
:func:`trace_from_numpy` / :func:`trace_to_numpy`, so a traced run resumes
in either package. Packs
of G lanes (a leading axis on every leaf, as the reference's ``vmap``
entries take them) cross the same way. The objects passed in only need
attributes with the right names, so nothing here imports the reference.

Where no JAX runs (the card host), the reference's answers travel as
numbers instead: :func:`state_digests` (a sha256 a leaf),
:func:`sim_record` (a result's parity fields) and :func:`config_doc` (a
configuration of either package as a JSON tree), compared through
:func:`canonical`. ``tools/ref_fixture.py`` writes them from the reference
and ``chip_smoke.py`` holds the card to them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from ...device import resolve
from ...obs.trace import TraceBuf
from .aria import AriaState
from .engine import NOTK, DynParams, Globals, Rows, SimState, Threads
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


def state_digests(state_np, lane: int | None = None) -> dict:
    """Each leaf of a numpy state -> ``[dtype, shape, sha256]`` of its
    C-ordered bytes, keyed ``"th.<f>"``, ``"rows.<f>"``, ``"g.<f>"`` for an
    engine state and ``"<f>"`` for an Aria state. Either package's state
    goes in (the reference's after ``np.asarray`` on every leaf); for a pack,
    ``lane`` picks one lane. Two states have equal digests exactly when
    every leaf has the same dtype, shape and values."""
    out = {}

    def walk(obj, prefix):
        for f, x in zip(obj._fields, obj):
            if isinstance(x, tuple) and hasattr(x, "_fields"):
                walk(x, f"{prefix}{f}.")
                continue
            a = np.ascontiguousarray(np.asarray(x) if lane is None
                                     else np.asarray(x)[lane])
            out[prefix + f] = [a.dtype.str, list(a.shape),
                               hashlib.sha256(a.tobytes()).hexdigest()]

    walk(state_np, "")
    return out


# SimResult fields a record carries (tests/test_sweep.py's parity bar)
INT_FIELDS = ("commits", "user_aborts", "forced_aborts", "lock_ops",
              "iters", "dd_ticks")
FLOAT_FIELDS = ("tps", "mean_latency_us", "p95_latency_us", "abort_rate",
                "lock_wait_frac", "cpu_util")


def sim_record(r) -> dict:
    """A ``SimResult`` of either package -> its parity fields."""
    return {f: getattr(r, f) for f in INT_FIELDS + FLOAT_FIELDS}


def _plain(x):
    """A numpy scalar or array inside a record as a host value or list (for
    ``json``)."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"not JSON: {type(x).__name__}")


def canonical(x) -> str:
    """One JSON text per value: records of either package, and the copy
    read back from a JSON file, compare equal exactly when their fields do
    (floats are written with ``repr``, so they round-trip; NaN equals NaN;
    keys are sorted as the strings JSON makes of them)."""
    return json.dumps(json.loads(json.dumps(x, default=_plain)),
                      sort_keys=True)


def config_doc(obj):
    """A configuration object of either package (dataclasses, NamedTuples,
    policies, arrival schedules) -> a JSON tree: each object its type name
    and fields, each array its dtype, shape and sha256. The port's and the
    reference's objects built alike give equal trees."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"type": type(obj).__name__,
                **{f.name: config_doc(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {"type": type(obj).__name__,
                **{f: config_doc(v) for f, v in zip(obj._fields, obj)}}
    if isinstance(obj, (list, tuple)):
        return [config_doc(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): config_doc(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {"dtype": a.dtype.str, "shape": list(a.shape),
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    if isinstance(obj, np.generic):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return {"type": type(obj).__name__,
            **{k: config_doc(v) for k, v in sorted(vars(obj).items())
               if not k.startswith("_")}}


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



def trace_from_numpy(tb, device=None):
    """An event buffer with numpy leaves (reference layout: ``alloc``-long
    columns) -> the port's ``TraceBuf`` on ``device``, its columns one sink
    slot longer."""
    dev = resolve(device)

    def col(a):
        a = np.asarray(a, np.int32)
        return _tensor(np.append(a, np.int32(NOTK)), dev)

    return TraceBuf(ts=col(tb.ts), tid=col(tb.tid), row=col(tb.row),
                    ev=col(tb.ev), n=_tensor(np.int32(tb.n), dev),
                    dropped=_tensor(np.int32(tb.dropped), dev),
                    cap=_tensor(np.int32(tb.cap), dev), on=bool(tb.on))


def trace_to_numpy(tb):
    """The port's ``TraceBuf`` -> the same NamedTuple in the reference's
    layout: ``alloc``-long numpy columns (the sink slot dropped), 0-d i32
    counters and a numpy bool switch."""
    def col(t):
        return t[:-1].detach().cpu().numpy()

    def scalar(t):
        return t.detach().cpu().numpy()

    return type(tb)(ts=col(tb.ts), tid=col(tb.tid), row=col(tb.row),
                    ev=col(tb.ev), n=scalar(tb.n), dropped=scalar(tb.dropped),
                    cap=scalar(tb.cap), on=np.asarray(tb.on))
