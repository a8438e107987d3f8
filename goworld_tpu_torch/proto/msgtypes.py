"""Filtered-client broadcast comparison ops (a copy of
``goworld_tpu.proto.msgtypes.FilterOp``)."""

from __future__ import annotations

import enum


class FilterOp(enum.IntEnum):
    """Filtered-client broadcast comparison ops (proto.go:142-151)."""

    EQ = 0
    NE = 1
    LT = 2
    LTE = 3
    GT = 4
    GTE = 5
