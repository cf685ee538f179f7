"""Straggler mitigation: detection + deterministic work rebalancing (a
copy of the reference's ``repro.distributed.straggler``; pure Python).

In synchronous SPMD training a slow host delays every step (the collective
is the barrier). Mitigations implemented at the planning layer:

  * detection: per-host step-time EWMA; a host is a straggler when its
    EWMA exceeds ``threshold`` x the fleet median,
  * mitigation 1 (rebalance): move a fraction of the straggler's data
    shards to the fastest hosts (deterministic plan; the data pipeline is
    keyed by (host, shard, step) so reassignment is exact),
  * mitigation 2 (eject): persistent stragglers are treated as failed and
    handed to the fault path (elastic re-mesh).

"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.2
    threshold: float = 1.5
    eject_after: int = 5
    _ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    _strikes: Dict[int, int] = dataclasses.field(default_factory=dict)

    def observe(self, host_id: int, step_time_s: float):
        prev = self._ewma.get(host_id, step_time_s)
        self._ewma[host_id] = (1 - self.alpha) * prev \
            + self.alpha * step_time_s

    def median(self) -> float:
        vals = sorted(self._ewma.values())
        return vals[len(vals) // 2] if vals else 0.0

    def stragglers(self) -> List[int]:
        med = self.median()
        out = []
        for h, t in self._ewma.items():
            if med > 0 and t > self.threshold * med:
                self._strikes[h] = self._strikes.get(h, 0) + 1
                out.append(h)
            else:
                self._strikes[h] = 0
        return sorted(out)

    def ejections(self) -> List[int]:
        return sorted(h for h, s in self._strikes.items()
                      if s >= self.eject_after)


def rebalance(shard_map_: Dict[int, List[int]], straggler: int,
              fraction: float = 0.5) -> Dict[int, List[int]]:
    """Move `fraction` of a straggler's shards to the least-loaded hosts."""
    plan = {h: list(s) for h, s in shard_map_.items()}
    if straggler not in plan or not plan[straggler]:
        return plan
    n_move = max(1, int(len(plan[straggler]) * fraction))
    moving = plan[straggler][-n_move:]
    plan[straggler] = plan[straggler][:-n_move]
    targets = sorted((h for h in plan if h != straggler),
                     key=lambda h: len(plan[h]))
    for i, s in enumerate(moving):
        plan[targets[i % len(targets)]].append(s)
    return plan
