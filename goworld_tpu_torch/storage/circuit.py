"""Per-backend circuit breaker for the storage worker.

No reference analog: GoWorld's storageRoutine retries a failed save forever
at a fixed 1 s (storage.go:197-240), sleeping INSIDE the single serial
worker — one dead backend wedges every other entity's persistence. The
breaker bounds that: after ``failure_threshold`` consecutive failures the
circuit OPENS and the worker stops touching the backend (ops defer into a
byte-capped queue, storage/__init__.py); after ``cooldown`` seconds the
next op becomes a HALF-OPEN probe — success closes the circuit, failure
re-opens it for another cooldown.

State values (``storage_circuit_state`` gauge): 0 = closed, 1 = open,
2 = half-open.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class CircuitBreaker:
    CLOSED = 0
    OPEN = 1
    HALF_OPEN = 2

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0

    def configure(self, failure_threshold: int, cooldown: float) -> None:
        with self._lock:
            self.failure_threshold = failure_threshold
            self.cooldown = cooldown

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller attempt the backend right now? OPEN past the
        cooldown transitions to HALF_OPEN and admits one probe."""
        with self._lock:
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.cooldown:
                    self._state = self.HALF_OPEN
                    return True
                return False
            return True  # CLOSED, or HALF_OPEN (the probe is the caller)

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._consecutive_failures = 0

    def record_failure(self) -> None:
        """A half-open probe failing re-opens immediately; a closed circuit
        opens at the consecutive-failure threshold."""
        with self._lock:
            self._consecutive_failures += 1
            if (self._state == self.HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()

    def reset(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._consecutive_failures = 0
            self._opened_at = 0.0
