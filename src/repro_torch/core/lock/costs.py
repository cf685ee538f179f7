"""Cycle cost model + per-protocol parameters for the CC engine.

Units: 1 tick = 0.1 microseconds. All costs are integer ticks.

The constants are calibrated (see benchmarks/) so the *shape* of every paper
figure reproduces: serial hotspot ~60k TPS, MySQL-at-1024-threads collapsing
below serial (Fig. 2a), O2 removing the deadlock-detection term, group
locking removing the per-update lock+commit serialization (Fig. 3), group
commit amortizing the replication sync (Fig. 5c).

Cost semantics (where each cost lands):
  - ``grant_overhead`` is paid on the *row's serial path* when a waiter is
    granted (it models the lock-manager bucket mutex work: lock record
    creation + deadlock detection scan, which the paper observes blocks
    other transactions on the same row/page).
  - deadlock detection cost is ``dd_coeff * queue_len`` ticks, added to the
    grant overhead (Fig. 2a's pathology: cost grows with the queue).
  - commit pays ``commit_base`` plus the replication sync latency
    (``sync_lat``); with group commit, members joining an in-flight batch
    complete with the batch (Fig. 5c).
"""
from __future__ import annotations

import dataclasses

PROTOCOLS = ("mysql", "o1", "o2", "group", "bamboo",
             "brook2pl")  # + "aria" (own module)


@dataclasses.dataclass(frozen=True)
class ProtocolParams:
    name: str
    # --- lock manager ---
    lock_base: int = 10          # lock record create/acquire (ticks)
    grant_cost: int = 2          # waking/granting a queued txn
    dd_coeff: float = 3.0        # deadlock-detection ticks per queued txn
    has_detection: bool = True   # 2-cycle waits-for detection active
    # --- hot-row handling ---
    hot_queue: bool = False      # O2/group: hot rows use the hotspot queue
    early_release: bool = False  # grant successor at update completion (hot)
    early_all: bool = False      # bamboo: early release on every row
    group_lock: bool = False     # leader/follower group locking
    group_commit: bool = False   # batch commit-phase sync within a group
    dynamic_batch: bool = True   # §4.6.1 dynamic batch size
    batch_size: int = 10         # group batch size (B)
    hot_threshold: int = 32      # §4.1 promotion threshold
    proactive_abort: bool = False  # §4.5 hot+non-hot proactive rollback
    # --- Brook-2PL (chop.py static analysis; deadlock-free 2PL) ---
    ordered_acquire: bool = False  # acquire rows in canonical chop order
    per_op_release: bool = False   # retire tickets at their last-use op
    # --- timeouts (ticks); <=0 disables ---
    wait_timeout: int = 500_000      # 50ms
    commit_wait_timeout: int = 500_000


@dataclasses.dataclass(frozen=True)
class CostModel:
    op_exec: int = 50            # row update work (5us: index lookup+apply)
    read_exec: int = 20          # snapshot read
    commit_base: int = 100       # commit bookkeeping (10us)
    sync_lat: int = 0            # replication sync latency (ticks); Fig 9
    rb_base: int = 80            # rollback fixed cost
    rb_per_op: int = 40          # per applied-op undo cost
    backoff: int = 200           # retry backoff after forced abort
    queue_insert: int = 3        # enqueue into hotspot queue (off crit path)
    arrival_rate: float = 0.0    # fixed-TPS model: txns/tick; 0 = closed loop
    # multi-row cascades can form rollback-order cycles (the multi-hot-row
    # deadlock the paper excludes, §6.5); a stuck rollback proceeds out of
    # order after this many ticks (value semantics commute, so the
    # serializability counter invariant is preserved).
    rb_turn_timeout: int = 20_000


def protocol_params(name: str, **over) -> ProtocolParams:
    base = {
        "mysql": dict(lock_base=12, dd_coeff=3.0, has_detection=True),
        "o1": dict(lock_base=4, dd_coeff=1.0, has_detection=True),
        "o2": dict(lock_base=4, dd_coeff=0.0, has_detection=False,
                   hot_queue=True),
        "group": dict(lock_base=4, dd_coeff=0.0, has_detection=False,
                      hot_queue=True, early_release=True, group_lock=True,
                      group_commit=True, proactive_abort=True),
        "bamboo": dict(lock_base=8, dd_coeff=1.0, has_detection=True,
                       early_all=True, early_release=True),
        # Brook-2PL: chop-ordered acquisition makes waits-for cycles
        # structurally impossible, so BOTH dynamic deadlock resolvers are
        # off — no detection walk (dd_coeff 0) and no lock-wait timeouts
        # (0 disables; a timeout would be the residual deadlock resolver
        # and its absence is the protocol's claim). Per-op release
        # shrinks hold intervals to [acquire, last-use].
        "brook2pl": dict(lock_base=4, dd_coeff=0.0, has_detection=False,
                         ordered_acquire=True, per_op_release=True,
                         wait_timeout=0, commit_wait_timeout=0),
    }[name]
    base.update(over)
    return ProtocolParams(name=name, **base)
