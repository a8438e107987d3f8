"""AOI manager interface (reference: aoi.AOIManager seam, Space.go:33)."""

from __future__ import annotations


class AOIManagerBase:
    """Per-space AOI manager interface.

    ``enter``/``leave``/``moved`` update membership; implementations fire
    ``entity.on_enter_aoi(other)`` / ``entity.on_leave_aoi(other)`` either
    synchronously (CPU sweep) or at the next ``tick()`` (batched, on the device).
    """

    def enter(self, entity, x: float, z: float) -> None:
        raise NotImplementedError

    def leave(self, entity) -> None:
        raise NotImplementedError

    def moved(self, entity, x: float, z: float) -> None:
        raise NotImplementedError

    def tick(self) -> None:
        """Deliver pending diffs (no-op for synchronous backends)."""

    def destroy(self) -> None:
        """Space destroyed: release resources."""
