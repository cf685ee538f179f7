"""Workload generators for the concurrency-control engine (PyTorch).

Each workload kind maps a (thread, txn_counter, op_slot) triple to a row key
and a read/write flag, deterministically, via an integer hash, so
transactions are (re)generated on the fly when a thread starts (or retries)
a transaction. The kinds, the hash and the key draws follow
``repro.core.lock.workload`` bit for bit:

  - ``hotspot_update``  op 0 writes THE hot row; remaining ops hit non-hot
                        keys.
  - ``hotspot_mix``     Zipf(SF) keys, RW mix.
  - ``hotspot_scan``    updates dispersed over a small warm set.
  - ``uniform``         uniform keys, RW mix.
  - ``zipf``            Zipf(SF) keys, all writes.
  - ``fit``             op 0 writes a hot account row, op 1 a uniform
                        non-hot row.
  - ``tpcc``            op 0 writes a warehouse row, op 1 a district row,
                        remaining ops mixed uniform.

Numerics that must match the reference exactly:

* The splitmix32 hash runs in int64 masked to 32 bits after every multiply
  and add (uint32 ``+`` and ``>>`` are not implemented for CPU tensors).
  Multiplies split the constant into 16-bit halves so no int64 product
  overflows.
* ``_uniform01`` converts the u32 value to f32 with round-to-nearest, so
  values >= 0xFFFFFF80 become 2**32 and ``u == 1.0`` happens; the clip after
  every draw keeps keys in range.
* The Zipf table is float32 and searched left-sided.

:class:`DynWorkload` holds host scalars plus two device tables (the Zipf CDF
and the chop acquisition rank), with the reference's field names. A pack of
G lanes stacks it (``engine.stack_lanes``): numpy (G,) scalars and (G, R)
tables. :func:`gen_txn_lanes` generates for a pack, with each scalar either
a host value (every lane agrees) or a (G, 1) tensor.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ...device import resolve
from . import chop

I32 = torch.int32
F32 = torch.float32
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    kind: str = "hotspot_update"
    n_rows: int = 8192          # key space (R)
    txn_len: int = 1            # ops per transaction (TL)
    write_ratio: float = 1.0    # fraction of non-structural ops that write
    zipf_s: float = 0.7         # skew factor (SF)
    n_hot: int = 4              # hot-set size for fit/hotspot_scan
    n_warehouses: int = 1       # tpcc
    seed: int = 0
    reads_lock: bool = False    # SER current reads (locks for reads)
    hot_base: int = 0           # hot-set anchor key (drift: migration)

    def __post_init__(self):
        assert self.txn_len >= 1
        assert self.kind in (
            "hotspot_update", "hotspot_mix", "hotspot_scan",
            "uniform", "zipf", "fit", "tpcc",
        )


class DynWorkload(NamedTuple):
    """Per-config workload values. Scalars are host values (f32-rounded
    where the reference holds f32); the tables live on the engine's device.
    Stacked over G lanes the scalars are numpy (G,) arrays in the
    reference's dtypes and the tables (G, R) tensors.
    """
    txn_len: int                # ACTIVE ops per txn (<= padded L)
    write_ratio: float          # f32 value
    n_hot: int
    n_warehouses: int
    seed: int
    reads_lock: bool
    hot_base: int               # hot-set anchor (0 = classic layout)
    zcdf: torch.Tensor          # (R,) f32 Zipf CDF
    acq_rank: torch.Tensor      # (R,) i32 chop lock-acquisition rank


def _f32(v) -> float:
    return float(np.float32(v))


def dyn_workload(spec: WorkloadSpec, device=None) -> DynWorkload:
    """Materialize the per-config view with its tables on ``device``."""
    dev = resolve(device)
    return DynWorkload(
        txn_len=int(spec.txn_len),
        write_ratio=_f32(spec.write_ratio),
        n_hot=int(spec.n_hot),
        n_warehouses=int(spec.n_warehouses),
        seed=int(spec.seed),
        reads_lock=bool(spec.reads_lock),
        hot_base=int(spec.hot_base),
        zcdf=zipf_cdf_table(spec.n_rows, spec.zipf_s, dev),
        acq_rank=torch.from_numpy(chop.acquisition_rank(spec)).to(dev),
    )


# ---------------------------------------------------------------------------
# integer hashing (splitmix32-style) in int64 masked to 32 bits
# ---------------------------------------------------------------------------

def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x, c in [0, 2**32). torch's int64 product
    wraps mod 2**64, which keeps the low 32 bits exact."""
    return (x * c) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer over u32 values held in int64."""
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _hash3(a, b, c, salt) -> torch.Tensor:
    """The reference's ``_hash3`` on int32 tensors (``salt`` an int or an
    int tensor that broadcasts), as int64 in [0, 2**32)."""
    a, b, c = (t.to(torch.int64) & _M32 for t in (a, b, c))
    h = _hash_u32((_mul_u32(a, 0x9E3779B9) + (salt & _M32)) & _M32)
    h = _hash_u32(h ^ _mul_u32(b, 0x85EBCA6B))
    return _hash_u32(h ^ _mul_u32(c, 0xC2B2AE35))


def _uniform01(h: torch.Tensor) -> torch.Tensor:
    return h.to(F32) * (1.0 / 4294967296.0)


def zipf_cdf(n: int, s: float) -> np.ndarray:
    """CDF of a Zipf(s) distribution over keys [0, n), as float32 (numpy).

    Weights come from ``chop.zipf_weights`` — the single definition the
    chop heat model also ranks by."""
    w = chop.zipf_weights(n, s)
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    return cdf.astype(np.float32)


def zipf_cdf_table(n: int, s: float, device=None) -> torch.Tensor:
    """Engine-facing CDF table, (R,) f32 on ``device``."""
    return torch.from_numpy(zipf_cdf(n, float(s))).to(resolve(device))


# ---------------------------------------------------------------------------
# transaction generation
# ---------------------------------------------------------------------------

def _scale(u: torch.Tensor, span) -> torch.Tensor:
    """``u * span`` rounded to f32, as the reference's i32 -> f32 promotion
    computes it. ``span`` < 2**24 is exact in f32, so the product of two f32
    values is exact in double and rounds to the same f32 either way."""
    if torch.is_tensor(span):
        return u * span.to(F32)
    assert 0 <= span < 2**24, span
    return u * float(span)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``clip(x, lo, hi)`` with either bound a host int or a tensor."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp(min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp(max=hi)


def _e(v):
    """A per-lane (G, 1) value broadcast against (G, T, L); host values
    pass through."""
    return v[..., None] if torch.is_tensor(v) else v


def gen_txn_lanes(kind: str, n_rows: int, L: int, dw: DynWorkload,
                  thread_ids: torch.Tensor, txn_ctr: torch.Tensor,
                  acq_order=False, skip_analysis: bool = False):
    """Generate transaction programs for every thread of G lanes.

    Args:
      kind: workload kind.
      n_rows: key space R.
      L: padded op-slot count. Slots >= ``dw.txn_len`` are generated but
         never executed (``nops`` stops the engine first).
      dw: the lanes' workload values: each scalar a host value shared by
         every lane or a (G, 1) tensor (``seed`` in int64), the tables
         (G, R) tensors.
      thread_ids: (T,) int32.
      txn_ctr: (G, T) int32 per-thread transaction counters.
      acq_order: re-sort each txn's active ops into the canonical chop rank
         order (``dw.acq_rank``) before the dup/last-use analysis
         (Brook-2PL's ``ordered_acquire``): a host bool, or a (G, 1) bool
         tensor that selects per lane.
      skip_analysis: the profiler's ``dup_analysis`` stand-in (engine
         ``PROF_STAGES``): skip the (G, T, L, L) pairwise scan, returning
         no dups and every active slot as a last use. Exact at txn_len 1.

    Returns ``keys`` (G, T, L) i32, ``iswr`` (G, T, L) bool, ``dup``
    (G, T, L) bool (key already written earlier in the txn), ``lastu``
    (G, T, L) bool (slot is its key's last active use) and ``nops`` (G, T)
    i32.
    """
    G, T = txn_ctr.shape
    dev = thread_ids.device
    tid = thread_ids[:, None]
    ctr = txn_ctr[..., None]
    slot = torch.arange(L, dtype=I32, device=dev)

    base = tid * 1_000_003 + ctr                          # i32, wraps
    # the key draw (c=0, salt seed*7+1) and the write draw (c=1, salt
    # seed*7+2) hashed together along a leading axis of 2
    pair = torch.arange(2, dtype=torch.int64, device=dev)[:, None, None, None]
    u_key, u_wr = _uniform01(_hash3(base[None], slot, pair,
                                    pair + (_e(dw.seed) * 7 + 1)))

    R = n_rows

    def zipf_keys(u):
        k = torch.searchsorted(dw.zcdf, u.reshape(G, -1).contiguous(),
                               right=False).view(u.shape)
        return k.clamp(0, R - 1).to(I32)

    def uniform_keys(u, lo=0, hi=None):
        hi = R if hi is None else hi
        return _clip(lo + _scale(u, hi - lo).to(I32), lo, hi - 1)

    wr = u_wr < _e(dw.write_ratio)

    hb = _e(dw.hot_base) % R

    if kind == "hotspot_update":
        k_rest = uniform_keys(u_key, lo=1)
        k_rest = torch.where(k_rest == hb, 0, k_rest)
        keys = torch.where(slot == 0, hb, k_rest).to(I32)
        iswr = (slot == 0) | wr
    elif kind == "hotspot_mix":
        keys = (zipf_keys(u_key) + hb) % R
        iswr = wr
    elif kind == "hotspot_scan":
        n_hot = _e(dw.n_hot)
        span = (n_hot * 16).clamp(min=2) if torch.is_tensor(n_hot) \
            else max(n_hot * 16, 2)
        keys = (uniform_keys(u_key, lo=0, hi=span) + hb) % R
        iswr = torch.ones_like(wr)
    elif kind == "uniform":
        keys = uniform_keys(u_key)
        iswr = wr
    elif kind == "zipf":
        keys = (zipf_keys(u_key) + hb) % R
        iswr = torch.ones_like(wr)
    elif kind == "fit":
        n_hot = _e(dw.n_hot)
        hot = (uniform_keys(u_key, lo=0, hi=n_hot) + hb) % R
        rest = uniform_keys(u_key, lo=n_hot)
        keys = torch.where(slot == 0, hot, rest)
        iswr = (slot <= 1) | wr
    elif kind == "tpcc":
        W = _e(dw.n_warehouses)
        wh = uniform_keys(u_key, lo=0, hi=W)
        dist = W + wh * 10 + uniform_keys(u_wr, lo=0, hi=10)
        rest = uniform_keys(u_key, lo=W * 11)
        keys = torch.where(slot == 0, wh, torch.where(slot == 1, dist, rest))
        iswr = (slot <= 1) | wr
    else:  # pragma: no cover
        raise ValueError(kind)

    keys = keys.to(I32)
    if torch.is_tensor(dw.reads_lock):
        iswr = iswr | _e(dw.reads_lock)
    elif dw.reads_lock:
        iswr = torch.ones_like(iswr)

    txn_len = _e(dw.txn_len)
    if acq_order is not False:
        sk, sw = chop.apply_acquisition_order(dw.acq_rank, keys, iswr,
                                              txn_len)
        if acq_order is True:
            keys, iswr = sk, sw
        else:
            keys = torch.where(_e(acq_order), sk, keys)
            iswr = torch.where(_e(acq_order), sw, iswr)

    active = slot < txn_len                              # (.., 1, L)
    nops = torch.zeros((G, T), dtype=I32, device=dev) + dw.txn_len
    if skip_analysis:
        return (keys, iswr, torch.zeros_like(iswr),
                torch.broadcast_to(active, iswr.shape), nops)
    # dup[i] = key i written at an earlier slot (re-entrant lock).
    eq = keys[..., :, None] == keys[..., None, :]        # (G, T, L, L)
    earlier = torch.ones((L, L), dtype=torch.bool, device=dev).tril(-1)
    dup = torch.any(eq & earlier & iswr[..., None, :], dim=-1) & iswr
    # lastu[i] = no LATER active slot touches key i (== chop.last_use).
    later = torch.ones((L, L), dtype=torch.bool, device=dev).triu(1)
    lastu = active & ~torch.any(eq & later & active[..., None, :], dim=-1)
    return keys, iswr, dup, lastu, nops


def gen_txn_dyn(kind: str, n_rows: int, L: int, dw: DynWorkload,
                thread_ids: torch.Tensor, txn_ctr: torch.Tensor,
                acq_order: bool = False, skip_analysis: bool = False):
    """One config's programs: :func:`gen_txn_lanes` at G = 1, with ``dw``
    the single-lane :class:`DynWorkload` and ``txn_ctr`` (T,). Returns
    (T, L) ``keys``/``iswr``/``dup``/``lastu`` and (T,) ``nops``."""
    lanes = dw._replace(zcdf=dw.zcdf[None], acq_rank=dw.acq_rank[None])
    out = gen_txn_lanes(kind, n_rows, L, lanes, thread_ids, txn_ctr[None],
                        acq_order=acq_order, skip_analysis=skip_analysis)
    return tuple(x[0] for x in out)


def gen_txn(spec: WorkloadSpec, thread_ids: torch.Tensor,
            txn_ctr: torch.Tensor):
    """Static-spec convenience wrapper around :func:`gen_txn_dyn`, its
    tables on the counters' device."""
    return gen_txn_dyn(spec.kind, spec.n_rows, spec.txn_len,
                       dyn_workload(spec, txn_ctr.device), thread_ids,
                       txn_ctr)


def will_abort_dyn(seed, p_abort, thread_ids: torch.Tensor,
                   txn_ctr: torch.Tensor) -> torch.Tensor:
    """Deterministic per-transaction injected-abort decision (Fig. 10).

    ``seed`` and ``p_abort`` are host values, or (G, 1) tensors (``seed``
    in int64) against (G, T) counters."""
    zero = torch.zeros_like(thread_ids)
    h = _hash3(thread_ids * 1_000_003 + txn_ctr, zero, zero, seed * 7 + 5)
    return _uniform01(h) < p_abort


def will_abort(spec: WorkloadSpec, p_abort: float,
               thread_ids: torch.Tensor, txn_ctr: torch.Tensor
               ) -> torch.Tensor:
    """Static-spec convenience wrapper around :func:`will_abort_dyn`; no
    abort at all where ``p_abort <= 0``."""
    if p_abort <= 0.0:
        return torch.zeros_like(thread_ids, dtype=torch.bool)
    return will_abort_dyn(int(spec.seed), _f32(p_abort), thread_ids, txn_ctr)


# ---------------------------------------------------------------------------
# drift schedules (non-stationary workloads)
# ---------------------------------------------------------------------------
# A drift schedule is a per-segment sequence of WorkloadSpecs sharing one
# compile key (same kind / n_rows / txn_len): only DynWorkload VALUES change
# segment-to-segment, so the segmented engine replays the same executable
# under every drift — the property the adaptive governor builds on.

@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """A named per-segment workload sequence with a stable compile key."""
    name: str
    specs: tuple          # one WorkloadSpec per segment

    def __post_init__(self):
        assert self.specs, "empty drift schedule"
        k0 = (self.specs[0].kind, self.specs[0].n_rows, self.specs[0].txn_len)
        for s in self.specs:
            assert (s.kind, s.n_rows, s.txn_len) == k0, (
                "drift must keep the compile key (kind, n_rows, txn_len) "
                f"stable: {k0} vs {(s.kind, s.n_rows, s.txn_len)}")

    @property
    def n_segments(self) -> int:
        return len(self.specs)

    def spec(self, k: int) -> WorkloadSpec:
        """Workload for segment k (clamped — schedules are extendable)."""
        return self.specs[min(k, len(self.specs) - 1)]

    @property
    def base(self) -> WorkloadSpec:
        return self.specs[0]


def stationary(base: WorkloadSpec, n_segments: int,
               name: str = "stationary") -> DriftSchedule:
    """No drift — the control schedule."""
    return DriftSchedule(name, (base,) * n_segments)


def hot_migration(base: WorkloadSpec, n_segments: int, *, n_sites: int = 4,
                  period: int = 2) -> DriftSchedule:
    """The hot set jumps between ``n_sites`` evenly spaced anchor keys
    every ``period`` segments (shifting-hotspot regime, Guo et al.)."""
    stride = max(base.n_rows // max(n_sites, 1), 1)
    specs = tuple(
        dataclasses.replace(
            base, hot_base=((k // max(period, 1)) % n_sites) * stride)
        for k in range(n_segments))
    return DriftSchedule("hot_migration", specs)


def skew_ramp(base: WorkloadSpec, n_segments: int, *, lo: float = 0.3,
              hi: float = 1.0) -> DriftSchedule:
    """Access skew ramps linearly lo -> hi over the run (Zipf s drift)."""
    den = max(n_segments - 1, 1)
    specs = tuple(
        dataclasses.replace(base, zipf_s=lo + (hi - lo) * k / den)
        for k in range(n_segments))
    return DriftSchedule("skew_ramp", specs)


def flash_crowd(base: WorkloadSpec, n_segments: int, *, at: float = 0.5,
                write_lo: float = 0.15, write_hi: float = 1.0,
                skew_hi: float | None = None) -> DriftSchedule:
    """Write-ratio step at fraction ``at`` of the run (a flash crowd of
    writers arrives); optionally the skew concentrates at the same time."""
    step = int(round(at * n_segments))
    specs = []
    for k in range(n_segments):
        crowd = k >= step
        repl = {"write_ratio": write_hi if crowd else write_lo}
        if skew_hi is not None and crowd:
            repl["zipf_s"] = skew_hi
        specs.append(dataclasses.replace(base, **repl))
    return DriftSchedule("flash_crowd", tuple(specs))


DRIFT_KINDS = ("stationary", "hot_migration", "skew_ramp", "flash_crowd")
