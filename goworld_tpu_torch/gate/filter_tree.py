"""Ordered filter-prop index for filtered client broadcast.

Reference parity: ``components/gate/FilterTree.go:12-102`` — the gate keeps,
per filter key, an ordered tree of (value, clientid) pairs so that
``CallFilteredClients(op, key, val)`` can visit clients whose prop compares to
``val`` under any of =, !=, <, <=, >, >= (proto.go:142-151). The reference
uses an LLRB tree; a bisect-maintained sorted list gives the same ordered
visits with O(log n) seek (string comparison order, as in the reference).
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterator

from goworld_tpu_torch.proto.msgtypes import FilterOp


class FilterTree:
    """Ordered (value, clientid) index for ONE filter key."""

    def __init__(self) -> None:
        # Sorted by (val, clientid); clientids are unique within a tree
        # because ClientProxy removes its old value before inserting a new one.
        self._items: list[tuple[str, str]] = []

    def __len__(self) -> int:
        return len(self._items)

    def insert(self, val: str, clientid: str) -> None:
        bisect.insort(self._items, (val, clientid))

    def remove(self, val: str, clientid: str) -> bool:
        i = bisect.bisect_left(self._items, (val, clientid))
        if i < len(self._items) and self._items[i] == (val, clientid):
            self._items.pop(i)
            return True
        return False

    # --- ordered visits (FilterTree.go:40-102) -----------------------------

    def visit(self, op: FilterOp, val: str) -> Iterator[str]:
        """Yield clientids whose stored value compares to ``val`` under
        ``op``. String comparison, matching the reference's tree order."""
        items = self._items
        lo = bisect.bisect_left(items, (val, ""))
        # First index whose value is strictly greater than val: (val+"\x00", "")
        # sorts after every (val, clientid) and before any larger value.
        hi = bisect.bisect_left(items, (val + "\x00", ""))
        if op == FilterOp.EQ:
            rng: Iterator[tuple[str, str]] = iter(items[lo:hi])
        elif op == FilterOp.NE:
            rng = iter(items[:lo] + items[hi:])
        elif op == FilterOp.LT:
            rng = iter(items[:lo])
        elif op == FilterOp.LTE:
            rng = iter(items[:hi])
        elif op == FilterOp.GT:
            rng = iter(items[hi:])
        elif op == FilterOp.GTE:
            rng = iter(items[lo:])
        else:  # pragma: no cover - exhaustive over FilterOp
            raise ValueError(f"bad filter op {op}")
        for _, clientid in rng:
            yield clientid

    def visit_each(self, op: FilterOp, val: str, fn: Callable[[str], None]) -> None:
        for cid in list(self.visit(op, val)):
            fn(cid)
