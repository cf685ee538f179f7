"""Fault tolerance: failure detection + elastic re-mesh planning (a copy
of the reference's ``repro.distributed.fault``, with ``elastic_mesh_shape``
from its ``repro.launch.mesh``; pure Python).

On a real cluster this runs against the coordination service; here the
*planning* layer is implemented and unit-tested (the decisions are pure
functions), and the container-scale integration test exercises
checkpoint -> kill -> restore -> reshard end-to-end on CPU devices.

Recovery protocol (mirrors §5.3 failure recovery):
  1. heartbeat loss > ``timeout`` marks a host failed,
  2. surviving hosts agree on the new device set (the journal's latest
     committed step is the restore point — commit order is total),
  3. ``elastic_mesh_shape`` picks the largest mesh preserving the model
     axis; ``reshard_plan`` maps old shards to new hosts,
  4. every host restores from the checkpoint with the *new* shardings
     (restore is sharding-agnostic) and training resumes at step k+1 —
    the data pipeline is a pure function of step, so no data is lost or
    replayed out of order.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host_id: int, now: Optional[float] = None):
        self._last[host_id] = time.monotonic() if now is None else now

    def failed(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout_s)


def reshard_plan(old_hosts: List[int], new_hosts: List[int],
                 n_shards: int) -> Dict[int, List[int]]:
    """Assign shard ranges to surviving hosts (contiguous, balanced)."""
    assert new_hosts, "no survivors"
    per = n_shards // len(new_hosts)
    extra = n_shards % len(new_hosts)
    plan: Dict[int, List[int]] = {}
    start = 0
    for i, h in enumerate(new_hosts):
        k = per + (1 if i < extra else 0)
        plan[h] = list(range(start, start + k))
        start += k
    return plan


def elastic_mesh_shape(n_devices: int, model_axis: int = 16):
    """Largest (data, model) grid on the surviving devices (fault path).

    Keeps the model axis intact (resharding TP state is the expensive
    direction); shrinks data parallelism to what survives.
    """
    while model_axis > 1 and n_devices % model_axis:
        model_axis //= 2
    data = max(n_devices // model_axis, 1)
    return (data, model_axis), ("data", "model")


@dataclasses.dataclass
class RecoveryDecision:
    restore_step: Optional[int]
    mesh_shape: tuple
    mesh_axes: tuple
    shard_plan: Dict[int, List[int]]


def plan_recovery(monitor: HeartbeatMonitor, journal,
                  devices_per_host: int, model_axis: int = 16,
                  now: Optional[float] = None) -> RecoveryDecision:
    alive = monitor.alive(now)
    n_dev = len(alive) * devices_per_host
    shape, axes = elastic_mesh_shape(max(n_dev, 1), model_axis)
    return RecoveryDecision(
        restore_step=journal.latest_committed(),
        mesh_shape=shape,
        mesh_axes=axes,
        shard_plan=reshard_plan(alive, alive, shape[0]),
    )
