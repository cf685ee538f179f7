"""Step journal: the ``hot_update_order`` persistence of §5.3, adapted (a
copy of the reference's ``repro.checkpoint.journal`` over the port's
``core.dependency.DependencyList``).

An append-only JSONL ledger of checkpoint attempts. Each save ASSIGNS a
monotone order (the dependency-list append), then COMMITS it only after the
atomic rename (commit order == assign order, enforced by DependencyList).
Restore reads the latest committed entry; uncommitted (crashed) attempts
are simply absent — re-running recovery is idempotent.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from ..core.dependency import DependencyList


class Journal:
    def __init__(self, path: str):
        self.path = path
        self._dep = DependencyList()
        self._committed: dict[int, int] = {}    # step -> order
        self._load()

    def _load(self):
        if not os.path.exists(self.path):
            return
        open_orders = []
        max_order = -1
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                max_order = max(max_order, rec["order"])
                if rec["event"] == "assign":
                    open_orders.append(rec["order"])
                elif rec["event"] == "commit":
                    if rec["order"] in open_orders:
                        open_orders.remove(rec["order"])
                    self._committed[rec["step"]] = rec["order"]
        # crash recovery: uncommitted assigns are rolled back in reverse
        # order (the paper's reverse hot_update_order replay)
        self._dep.recover(open_orders)
        for o in sorted(open_orders, reverse=True):
            self._dep.rollback(o)
        self._dep.bump(max_order + 1)

    def _append(self, rec):
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def assign(self, step: int) -> int:
        order = self._dep.assign()
        self._append({"event": "assign", "step": step, "order": order})
        return order

    def commit(self, step: int, order: int):
        self._dep.commit(order)
        self._append({"event": "commit", "step": step, "order": order})
        self._committed[step] = order

    def latest_committed(self) -> Optional[int]:
        return max(self._committed) if self._committed else None

    def committed_steps(self):
        return sorted(self._committed)
