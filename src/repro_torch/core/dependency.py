"""Dependency-list order bookkeeping (§4.2-§4.4, host-side).

A minimal, strictly-checked implementation of the paper's dependency list:
a monotone ``hot_update_order`` is assigned per update; commits must happen
in assigned order; rollbacks in reverse order. Used by the checkpoint
journal (ordered step commits / ordered restore) and the serving queue, and
property-tested directly against the paper's Algorithms 2-3 invariants.
"""
from __future__ import annotations


class DependencyError(RuntimeError):
    pass


class DependencyList:
    """Ordered open-update ledger for one hotspot resource."""

    def __init__(self) -> None:
        self._next_order = 0
        self._open: list[int] = []      # orders in update order, uncommitted

    def assign(self) -> int:
        """New update: append to the dependency list (Alg. 1 line 8-9)."""
        order = self._next_order
        self._next_order += 1
        self._open.append(order)
        return order

    @property
    def open_orders(self) -> tuple[int, ...]:
        return tuple(self._open)

    def can_commit(self, order: int) -> bool:
        """Committable iff no preceding open update (§4.3)."""
        return bool(self._open) and self._open[0] == order

    def commit(self, order: int) -> None:
        if not self.can_commit(order):
            raise DependencyError(
                f"commit order violation: {order} is not the head of "
                f"{self._open}")
        self._open.pop(0)

    def can_rollback(self, order: int) -> bool:
        """Rollbackable iff no subsequent open update (§4.4)."""
        return bool(self._open) and self._open[-1] == order

    def rollback(self, order: int) -> None:
        if not self.can_rollback(order):
            raise DependencyError(
                f"rollback order violation: {order} is not the tail of "
                f"{self._open}")
        self._open.pop()

    def rollback_all_from(self, order: int) -> list[int]:
        """Cascade: roll back every open update >= order, reverse order."""
        rolled = []
        while self._open and self._open[-1] >= order:
            rolled.append(self._open.pop())
        if self._open and order in self._open:  # pragma: no cover
            raise DependencyError("cascade left a stale open order")
        return rolled

    def recover(self, persisted_open: list[int]) -> list[int]:
        """Failure recovery (§5.3): rebuild from persisted orders and
        return the rollback sequence (reverse ``hot_update_order``)."""
        self._open = sorted(persisted_open)
        self._next_order = max(self._next_order,
                               (self._open[-1] + 1) if self._open else 0)
        return list(reversed(self._open))

    def bump(self, next_order: int) -> None:
        """Ensure future orders start at least at ``next_order``."""
        self._next_order = max(self._next_order, next_order)
