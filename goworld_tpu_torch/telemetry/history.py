"""Crash-survivable telemetry history rings (the per-process black box).

Every process (game, gate, dispatcher, bench) can append compact periodic
telemetry *frames* — counter deltas, gauge values, histogram bucket deltas
plus live percentiles, and the flight recorder's per-tick rows — to a
bounded on-disk ring of fixed-size segment files. The ring survives the
process: after a kill -9 the segments hold every completed frame, and the
reader tolerates (and counts) the one torn frame a crash mid-append can
leave at the write head.

File format — one frame is::

    <III header: MAGIC, payload_len, crc32(payload)><payload JSON bytes>

appended to segment files named ``seg-%08d`` under the history directory.
A writer always starts a fresh segment (never appends into a file a dead
incarnation may have torn), rotates to a new segment when the current one
would exceed ``segment_bytes``, and unlinks the oldest segments beyond
``segments`` — drop-oldest, so disk use is bounded by
``segments * segment_bytes`` regardless of uptime.

Hot-loop cost is near zero by construction: the writer rides the snapshot
cadence (an asyncio task *off* the logic loop), and the per-frame encode
path (:meth:`HistoryWriter._encode_frame`) is loop-free over a
preallocated grow-only buffer — gwlint HOT_PATHS keeps it that way.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import struct
import time
import zlib
from typing import Any, Callable, Optional

from goworld_tpu_torch.telemetry.metrics import REGISTRY, Registry

#: "GWH1" little-endian — first 4 bytes of every frame.
MAGIC = 0x31485747
_HEADER = struct.Struct("<III")
HEADER_SIZE = _HEADER.size

_SEG_PREFIX = "seg-"

_M_WRITTEN = REGISTRY.counter(
    "history_frames_written_total",
    "Telemetry history frames appended to the on-disk ring.")
_M_TRUNCATED = REGISTRY.counter(
    "history_frames_truncated_total",
    "Torn history frames tolerated (and dropped) on ring recovery.")
_M_BYTES = REGISTRY.counter(
    "history_bytes_written_total",
    "Bytes appended to the telemetry history ring.")
_M_ROTATIONS = REGISTRY.counter(
    "history_segment_rotations_total",
    "History ring segment rotations (drop-oldest beyond the bound).")


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _seg_index(name: str) -> int:
    return int(name[len(_SEG_PREFIX):])


def list_segments(dir: str) -> list[str]:
    """Segment file paths under ``dir``, oldest first."""
    try:
        names = [n for n in os.listdir(dir)
                 if n.startswith(_SEG_PREFIX) and n[len(_SEG_PREFIX):].isdigit()]
    except FileNotFoundError:
        return []
    return [os.path.join(dir, n)
            for n in sorted(names, key=_seg_index)]


def read_segment(path: str) -> tuple[list[dict], int]:
    """Parse one segment: ``(frames, torn)`` where ``torn`` is 1 when the
    segment ends in a torn frame (crash mid-append) and 0 otherwise. A
    torn tail — short header, short payload, bad magic, or CRC mismatch —
    ends the segment; everything before it is returned."""
    with open(path, "rb") as f:
        data = f.read()
    frames: list[dict] = []
    off = 0
    n = len(data)
    while off < n:
        if off + HEADER_SIZE > n:
            return frames, 1
        magic, plen, crc = _HEADER.unpack_from(data, off)
        if magic != MAGIC:
            return frames, 1
        end = off + HEADER_SIZE + plen
        if end > n:
            return frames, 1
        payload = data[off + HEADER_SIZE:end]
        if zlib.crc32(payload) != crc:
            return frames, 1
        try:
            frames.append(json.loads(payload))
        except ValueError:
            return frames, 1
        off = end
    return frames, 0


def read_frames(dir: str) -> tuple[list[dict], int]:
    """Every complete frame under ``dir`` (oldest first) plus the number
    of torn tails tolerated — counted on
    ``history_frames_truncated_total``. A clean shutdown leaves 0 torn
    tails; a kill -9 mid-append leaves exactly one."""
    frames: list[dict] = []
    truncated = 0
    for path in list_segments(dir):
        got, torn = read_segment(path)
        frames.extend(got)
        truncated += torn
    if truncated:
        _M_TRUNCATED.inc(truncated)
    return frames, truncated


class HistoryWriter:
    """Appends periodic telemetry frames for one process to a bounded
    on-disk ring.

    ``health`` is a zero-arg callable returning the process's health dict
    (the same one its debug HTTP ``/healthz`` serves); ``flight`` is the
    process's FlightRecorder (or None) — only per-tick rows newer than the
    previous frame are included, so frames stay compact. Counter and
    histogram series are written as *deltas* against the previous frame;
    gauges as current values.

    ``write_frame`` is synchronous (bench drives it directly);
    :meth:`run` is the asyncio cadence loop services spawn next to their
    other housekeeping tasks. :meth:`close` writes one last frame marked
    ``final`` — after a cooperative shutdown (including a chaos kill that
    cancels the service task) the ring's newest frame holds the process's
    final ticks and census.
    """

    def __init__(self, dir: str, process: str, *,
                 interval: float = 1.0,
                 segment_bytes: int = 262144,
                 segments: int = 8,
                 health: Optional[Callable[[], dict]] = None,
                 flight: Any = None,
                 registry: Optional[Registry] = None) -> None:
        self.dir = dir
        self.process = process
        self.interval = max(0.01, float(interval))
        self.segment_bytes = max(4096, int(segment_bytes))
        self.segments = max(2, int(segments))
        self._health = health
        self._flight = flight
        self._registry = registry if registry is not None else REGISTRY
        self._buf = bytearray(4096)  # grow-only frame encode buffer
        self._prev_counters: dict[tuple, float] = {}
        self._prev_hist: dict[tuple, tuple] = {}  # key -> (count, sum, cum)
        self._last_flight_ts = 0.0
        self._seq = 0
        self.frames_written = 0
        self.recent: collections.deque = collections.deque(maxlen=64)
        self._f = None
        self._seg_bytes_left = 0
        os.makedirs(dir, exist_ok=True)
        self._open_segment()

    # --- segment management --------------------------------------------------

    def _open_segment(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        paths = list_segments(self.dir)
        nxt = _seg_index(os.path.basename(paths[-1])) + 1 if paths else 0
        path = os.path.join(self.dir, f"{_SEG_PREFIX}{nxt:08d}")
        self._f = open(path, "ab")
        self._seg_bytes_left = self.segment_bytes
        # Drop-oldest: the new segment counts toward the bound.
        excess = len(paths) + 1 - self.segments
        for old in paths[:max(0, excess)]:
            try:
                os.unlink(old)
            except OSError:
                pass
            _M_ROTATIONS.inc()

    # --- frame encode (gwlint HOT_PATHS: no per-frame object churn) ---------

    def _encode_frame(self, payload: bytes) -> memoryview:
        n = HEADER_SIZE + len(payload)
        if len(self._buf) < n:
            self._buf.extend(bytes(n - len(self._buf)))
        _HEADER.pack_into(self._buf, 0, MAGIC, len(payload),
                          zlib.crc32(payload))
        self._buf[HEADER_SIZE:n] = payload
        return memoryview(self._buf)[:n]

    # --- collection ----------------------------------------------------------

    def _collect(self, final: bool) -> dict:
        counters: dict[str, list] = {}
        gauges: dict[str, list] = {}
        hists: dict[str, list] = {}
        snap = self._registry.snapshot()
        for name, fam_snap in snap.items():
            kind = fam_snap["type"]
            if kind == "counter":
                out = []
                for s in fam_snap["series"]:
                    key = (name,) + _labels_key(s["labels"])
                    prev = self._prev_counters.get(key, 0.0)
                    self._prev_counters[key] = s["value"]
                    d = s["value"] - prev
                    if d:
                        out.append([s["labels"], d])
                if out:
                    counters[name] = out
            elif kind == "gauge":
                out = [[s["labels"], s["value"]]
                       for s in fam_snap["series"]]
                if out:
                    gauges[name] = out
            else:
                fam = self._registry.family(name)
                if fam is None:
                    continue
                out = []
                for values, child in fam.children():
                    labels = dict(zip(fam.labelnames, values))
                    key = (name,) + _labels_key(labels)
                    cum = [c for _, c in child.cumulative_buckets()]
                    le = [b for b, _ in child.cumulative_buckets()]
                    pc, ps, pcum = self._prev_hist.get(
                        key, (0, 0.0, [0] * len(cum)))
                    if len(pcum) != len(cum):
                        pcum = [0] * len(cum)
                    self._prev_hist[key] = (child.count, child.sum, cum)
                    count_d = child.count - pc
                    if not count_d and not final:
                        continue
                    out.append([labels, {
                        "count_d": count_d,
                        "sum_d": child.sum - ps,
                        "buckets_d": [c - p for c, p in zip(cum, pcum)],
                        "le": [("inf" if b == float("inf") else b)
                               for b in le],
                        "max": child.max,
                        "p50": child.percentile(0.50),
                        "p95": child.percentile(0.95),
                        "p99": child.percentile(0.99),
                        "p999": child.percentile(0.999),
                    }])
                if out:
                    hists[name] = out
        frame: dict = {
            "v": 1,
            "ts": round(time.time(), 6),
            "seq": self._seq,
            "process": self.process,
            "counters": counters,
            "gauges": gauges,
            "hist": hists,
        }
        if final:
            frame["final"] = True
        if self._health is not None:
            try:
                frame["health"] = self._health()
            except Exception:
                frame["health"] = None
        if self._flight is not None:
            ticks = [t for t in self._flight.ticks()
                     if t.get("ts", 0.0) > self._last_flight_ts]
            if ticks:
                self._last_flight_ts = ticks[-1]["ts"]
            frame["flight"] = ticks
        return frame

    # --- writing -------------------------------------------------------------

    def write_frame(self, final: bool = False) -> dict:
        """Collect and append one frame; returns the frame dict. Flushes
        to the OS so a subsequent kill -9 loses at most the frame a crash
        tears mid-``write``."""
        if self._f is None:  # closed (shutdown race with the run() task)
            return {}
        frame = self._collect(final)
        payload = json.dumps(frame, separators=(",", ":")).encode()
        view = self._encode_frame(payload)
        if len(view) > self._seg_bytes_left:
            self._open_segment()
        assert self._f is not None
        self._f.write(view)
        self._f.flush()
        self._seg_bytes_left -= len(view)
        self._seq += 1
        self.frames_written += 1
        _M_WRITTEN.inc()
        _M_BYTES.inc(len(view))
        self.recent.append(frame)
        return frame

    async def run(self) -> None:
        """Cadence loop: one frame per ``interval``. Cancel-safe — the
        service's shutdown path calls :meth:`close` for the final frame."""
        while True:
            await asyncio.sleep(self.interval)
            try:
                self.write_frame()
            except Exception:
                # The black box must never take the process down with it.
                from goworld_tpu_torch.utils import gwlog
                gwlog.warnf("history frame write failed (dir=%s)", self.dir)

    def close(self, final: bool = True) -> None:
        if self._f is None:
            return
        if final:
            try:
                self.write_frame(final=True)
            except Exception:
                pass
        self._f.close()
        self._f = None

    def snapshot(self) -> dict:
        """The ``/history`` debug route payload: ring location plus the
        most recent frames (in-memory mirror — no disk read)."""
        return {
            "dir": self.dir,
            "process": self.process,
            "interval": self.interval,
            "segment_bytes": self.segment_bytes,
            "segments": self.segments,
            "frames_written": self.frames_written,
            "recent": list(self.recent)[-16:],
        }


# --- module state (the process's writer; debug_http's /history serves it) ----

_active: Optional[HistoryWriter] = None


def set_active_writer(w: HistoryWriter) -> None:
    global _active
    _active = w


def clear_active_writer(w: Optional[HistoryWriter] = None) -> None:
    global _active
    if w is None or _active is w:
        _active = None


def active_writer() -> Optional[HistoryWriter]:
    return _active
