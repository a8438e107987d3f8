"""Sampled distributed tracing + slow-tick flight recorder.

The metrics say *that* a phase is slow; this module says *where one
specific request spent its time* as it crosses the paper's multi-process
routing path (gate → dispatcher → game → dispatcher → gate). The design
follows the AsyncTaichi / CheetahGIS observation that once execution is
batched and asynchronous, per-request causal traces — not aggregate
counters — are the only way to attribute latency:

- A :class:`TraceContext` (trace_id u64, span_id u64, flags u8) is minted
  at ingress seams (gate client RPC receive, game timer origination) with
  head sampling at ``[telemetry] trace_sample_rate`` (1/N; default 1/1024,
  0 disables). Unsampled traffic never allocates anything — every helper
  early-returns on a single global read, and the wire stays byte-identical
  to an untraced build.
- Sampled contexts piggyback across cluster links as a 17-byte packet
  trailer flagged by the high bit of the u16 msgtype (proto/conn.py;
  PROTO_VERSION 4). Each process strips the trailer at its recv seam and
  parents its own spans onto the sender's span id, so one trace id names
  the whole cross-process tree including dispatcher queue-dwell time.
- Finished spans land in a fixed-size, lock-cheap ring (drop-oldest,
  counted on ``trace_spans_dropped_total``), served by debug_http as
  ``GET /trace`` (Chrome trace-event JSON for one process; ``?raw=1`` for
  the span list tools/tracecat.py merges across processes).
- :class:`FlightRecorder` keeps the last N game ticks (phase durations,
  queue depth, entity/AOI counts); a tick over ``[telemetry]
  slow_tick_budget`` dumps the ring plus the tick's sampled spans as ONE
  structured WARN, retrievable at ``GET /flight``.

Thread model: the active-context global is only touched by the process's
single logic loop (scopes are entered and exited synchronously, never
across an await); the span ring takes one lock per *finished sampled
span* so off-loop recorders (the storage worker) stay safe.
"""

from __future__ import annotations

import collections
import json
import random
import struct
import time
from typing import Optional

from goworld_tpu_torch.telemetry.metrics import REGISTRY

#: flags bit 0: sampled (the only flag so far; the u8 is wire-reserved).
FLAG_SAMPLED = 0x01

#: Wire trailer appended to sampled cluster packets: trace_id u64 LE,
#: span_id u64 LE, flags u8 — 17 bytes (proto/conn.py attaches/strips it).
TRAILER = struct.Struct("<QQB")
TRAILER_SIZE = TRAILER.size

#: monotonic → epoch offset, sampled once: every process on a host derives
#: the same offset (same clocks), so merged timelines line up to ~µs.
_EPOCH_OFFSET = time.time() - time.monotonic()

_DROPPED = REGISTRY.counter(
    "trace_spans_dropped_total",
    "Finished spans evicted from the trace ring (drop-oldest).")


def mono_to_epoch(t: float) -> float:
    return t + _EPOCH_OFFSET


class TraceContext:
    """Identity of one sampled request as it crosses processes.

    ``span_id`` is the id of the *currently active* span — the parent for
    any child span or downstream process. ``born`` is the local monotonic
    receive time when the context arrived by wire (None for locally
    minted roots); queue-dwell spans measure from it.
    """

    __slots__ = ("trace_id", "span_id", "flags", "born")

    def __init__(self, trace_id: int, span_id: int,
                 flags: int = FLAG_SAMPLED,
                 born: Optional[float] = None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags
        self.born = born

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    def __repr__(self) -> str:
        return (f"TraceContext<{self.trace_id:016x}/{self.span_id:016x}"
                f" flags={self.flags:#x}>")


def encode_trailer(ctx: TraceContext) -> bytes:
    return TRAILER.pack(ctx.trace_id, ctx.span_id, ctx.flags)


def decode_trailer(data: bytes) -> TraceContext:
    trace_id, span_id, flags = TRAILER.unpack(data)
    return TraceContext(trace_id, span_id, flags, born=time.monotonic())


class SpanRing:
    """Fixed-size ring of finished spans; drop-oldest, counted."""

    def __init__(self, capacity: int = 4096) -> None:
        import threading

        self.capacity = max(1, capacity)
        self._buf: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def append(self, span: dict) -> None:
        with self._lock:
            if len(self._buf) >= self.capacity:
                self._buf.popleft()
                _DROPPED.inc()
            self._buf.append(span)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)


# --- module state -------------------------------------------------------------

# 1/N head-sampling denominator; 0 = tracing off. A plain int read is the
# entire unsampled fast path at every instrumentation point.
_sample_n: int = 1024
_ring = SpanRing(4096)
_current: Optional[TraceContext] = None


def configure(sample_rate: Optional[int] = None,
              ring_size: Optional[int] = None) -> None:
    """Set the head-sampling denominator (1/N; 0 disables) and/or resize
    the span ring (existing spans are kept up to the new capacity)."""
    global _sample_n, _ring
    if sample_rate is not None:
        _sample_n = max(0, int(sample_rate))
    if ring_size is not None and ring_size != _ring.capacity:
        old = _ring.snapshot()
        _ring = SpanRing(ring_size)
        for s in old[-ring_size:]:
            _ring.append(s)


def configure_from_config(tcfg) -> None:
    """Apply a read_config.TelemetryConfig (each process at boot). Also
    the [telemetry] seam for the device-runtime sentinel: every process
    that configures tracing gets its retrace warm threshold set here."""
    configure(sample_rate=tcfg.trace_sample_rate,
              ring_size=tcfg.trace_ring_size)
    from goworld_tpu_torch.telemetry import sentinel

    sentinel.configure_from_config(tcfg)


def sample_rate() -> int:
    return _sample_n


def current() -> Optional[TraceContext]:
    """The active sampled context, or None (the common case)."""
    return _current


def maybe_sample() -> Optional[TraceContext]:
    """Head-sampling coin flip at an ingress seam: a fresh root context
    1-in-N times, else None. Cost when unsampled: one int compare + one
    getrandbits."""
    n = _sample_n
    if n <= 0:
        return None
    if n > 1 and random.getrandbits(30) % n:
        return None
    return TraceContext(_new_id(), _new_id())


def _new_id() -> int:
    # Nonzero 64-bit ids: zero is the "no parent" sentinel in exports.
    return random.getrandbits(64) | 1


#: public alias for off-loop recorders (storage worker span ids).
new_span_id = _new_id


class SpanScope:
    """One in-progress span; activates a child context while entered.

    Use via the helpers (:func:`root_scope`, :func:`continue_from_packet`)
    in an ``if scope is None: ... else: with scope: ...`` shape so the
    unsampled path never constructs anything.
    """

    __slots__ = ("name", "ctx", "parent_id", "args", "_prev", "_t0")

    def __init__(self, name: str, parent: TraceContext,
                 start: Optional[float] = None) -> None:
        self.name = name
        self.parent_id = parent.span_id
        self.ctx = TraceContext(parent.trace_id, _new_id(), parent.flags)
        self.args: dict = {}
        self._prev: Optional[TraceContext] = None
        self._t0 = time.monotonic() if start is None else start

    def __enter__(self) -> "SpanScope":
        global _current
        self._prev = _current
        _current = self.ctx
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _current
        _current = self._prev
        end = time.monotonic()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        record_span(self.name, self._t0, end - self._t0, self.ctx.trace_id,
                    self.ctx.span_id, self.parent_id,
                    self.args or None)


def root_scope(name: str) -> Optional[SpanScope]:
    """Ingress helper: head-sample and open a root span, or None."""
    ctx = maybe_sample()
    if ctx is None:
        return None
    scope = SpanScope(name, ctx)
    # The root scope's own span IS the minted context's span (not a child
    # of it): keep the ids identical so the wire parent is the root.
    scope.ctx = ctx
    scope.parent_id = 0
    return scope


def child_scope(name: str) -> Optional[SpanScope]:
    """A child span of the active context, or None when untraced."""
    ctx = _current
    if ctx is None:
        return None
    return SpanScope(name, ctx)


def continue_from_packet(packet, name: str,
                         dwell_name: str = "queue_dwell"
                         ) -> Optional[SpanScope]:
    """Resume a trace that arrived on ``packet`` (recv seam attached
    ``packet.trace``): opens a handling span parented on the sender's
    span and records the local queue-dwell (recv → handling start) as its
    own child span — the dispatcher's dwell is exactly this."""
    ctx = packet.trace
    if ctx is None:
        return None
    scope = SpanScope(name, ctx)
    born = ctx.born
    if born is not None:
        now = time.monotonic()
        # Dwell is a child of the handling span so the timeline reads
        # handle = [dwell][processing].
        record_span(dwell_name, born, now - born, ctx.trace_id,
                    _new_id(), scope.ctx.span_id)
        scope._t0 = born  # the handling span covers dwell + processing
    return scope


def record_span(name: str, start_mono: float, duration: float,
                trace_id: int, span_id: int, parent_id: int = 0,
                args: Optional[dict] = None) -> None:
    """Low-level append of a finished span (storage worker, dwell spans,
    phase spans). ``start_mono`` is local monotonic; stored as epoch."""
    span = {
        "name": name,
        "ts": mono_to_epoch(start_mono),
        "dur": duration if duration >= 0.0 else 0.0,
        "trace": trace_id,
        "span": span_id,
        "parent": parent_id,
    }
    if args:
        span["args"] = args
    _ring.append(span)


def record_phase_spans(trace_id: int, t0_mono: float,
                       phases: dict[str, float]) -> None:
    """Emit one span per tick phase as consecutive intervals from the
    tick start — the PhaseTracer boundaries of a tick that handled a
    sampled packet, placed on the same timeline as that packet's spans.
    (Re-marked phases are merged segments, so the layout is the tick's
    phase *budget*, not an exact interleaving.)"""
    at = t0_mono
    for phase, took in phases.items():
        record_span(f"tick.{phase}", at, took, trace_id, _new_id())
        at += took


def snapshot() -> list[dict]:
    """The ring's finished spans, oldest first (``/trace?raw=1``)."""
    return _ring.snapshot()


def export_chrome(process_name: str, pid: int = 1) -> dict:
    """Chrome trace-event JSON for THIS process's ring — loadable directly
    in Perfetto / chrome://tracing; tools/tracecat.py merges several."""
    return {"traceEvents": chrome_events(snapshot(), process_name, pid)}


def chrome_events(spans: list[dict], process_name: str,
                  pid: int) -> list[dict]:
    """Span dicts → chrome trace events (one metadata row + X events)."""
    events: list[dict] = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    for s in spans:
        events.append({
            "ph": "X",
            "pid": pid,
            "tid": 0,
            "ts": round(s["ts"] * 1e6, 1),
            "dur": max(round(s["dur"] * 1e6, 1), 0.1),
            "name": s["name"],
            "cat": s["name"].split(".", 1)[0],
            "args": {
                "trace_id": f"{s['trace']:016x}",
                "span_id": f"{s['span']:016x}",
                "parent_id": f"{s['parent']:016x}",
                **(s.get("args") or {}),
            },
        })
    return events


def reset_for_tests() -> None:
    global _current, _sample_n, _flight
    _current = None
    _sample_n = 1024
    _ring.clear()
    _flight = None
    configure(ring_size=4096)


# --- slow-tick flight recorder ------------------------------------------------


class FlightRecorder:
    """Ring of the last N game-tick records + slow-tick dump.

    Every tick costs one small dict + deque append. A tick whose busy
    span exceeds ``slow_budget`` seconds dumps the ring, the offending
    tick, and the trace ring's sampled spans overlapping that tick as ONE
    structured WARN (rate-limited), kept retrievable at ``GET /flight``.
    """

    def __init__(self, capacity: int = 240, slow_budget: float = 0.1,
                 warn_interval: float = 10.0) -> None:
        self.capacity = max(1, capacity)
        self.slow_budget = slow_budget
        self.warn_interval = warn_interval
        self._ticks: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.slow_ticks = 0
        self.last_slow: Optional[dict] = None
        self._last_warn = 0.0

    def ticks(self) -> list:
        """Snapshot of the ring (oldest first) — the load report's
        tick-p95 source (rebalance/report.py)."""
        return list(self._ticks)

    def record(self, t0_mono: float, total: float,
               phases: dict[str, float], **extra) -> None:
        entry = {
            "ts": round(mono_to_epoch(t0_mono), 6),
            "total_ms": round(total * 1000.0, 3),
            "phases_ms": {p: round(v * 1000.0, 3)
                          for p, v in phases.items()},
        }
        entry.update(extra)
        self._ticks.append(entry)
        if 0 < self.slow_budget <= total:
            self._dump(entry, t0_mono, total)

    def _dump(self, entry: dict, t0_mono: float, total: float) -> None:
        self.slow_ticks += 1
        t0, t1 = mono_to_epoch(t0_mono), mono_to_epoch(t0_mono) + total
        spans = [s for s in snapshot()
                 if s["ts"] < t1 and s["ts"] + s["dur"] > t0]
        self.last_slow = {
            "tick": entry,
            "budget_ms": round(self.slow_budget * 1000.0, 3),
            "spans": spans,
            "recent_ticks": list(self._ticks),
            "slow_ticks_total": self.slow_ticks,
        }
        now = time.monotonic()
        if now - self._last_warn >= self.warn_interval:
            self._last_warn = now
            from goworld_tpu_torch.utils import gwlog

            # ONE structured line: the whole incident is machine-readable
            # from the log alone (the /flight endpoint serves the same
            # record with the full ring).
            gwlog.warnf(
                "slow tick: %s",
                json.dumps({
                    "tick": entry,
                    "budget_ms": self.last_slow["budget_ms"],
                    "spans": spans[-40:],
                    "recent_ticks": list(self._ticks)[-20:],
                    "slow_ticks_total": self.slow_ticks,
                }, separators=(",", ":")))

    def snapshot(self) -> dict:
        return {
            "capacity": self.capacity,
            "slow_budget_ms": round(self.slow_budget * 1000.0, 3),
            "slow_ticks_total": self.slow_ticks,
            "recent": list(self._ticks),
            "last_slow": self.last_slow,
        }


# The game process registers its recorder here; debug_http's /flight
# serves it (None on processes without a tick loop).
_flight: Optional[FlightRecorder] = None


def set_flight_recorder(rec: Optional[FlightRecorder]) -> None:
    global _flight
    _flight = rec


def flight_recorder() -> Optional[FlightRecorder]:
    return _flight
