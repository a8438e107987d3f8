"""Per-process debug HTTP server.

Reference parity: ``engine/binutil/binutil.go:26-47`` — every process embeds
an always-on HTTP server (pprof + expvar) on the config ``http_addr``.
Python-native design: a minimal asyncio HTTP/1.1 responder (no external web
framework in this image) serving:

- ``/healthz``   — one JSON object: process kind/id, uptime, PROTO_VERSION,
  dispatcher link states + last-seen ages, entity/client counts (the
  service registers a provider via :func:`set_health_provider`); ops
  probes and the chaos harness read THIS, not /metrics text
- ``/vars``      — JSON snapshot of gwvar published variables (expvar parity)
- ``/metrics``   — Prometheus text exposition of the telemetry registry
  (tick-phase histograms, AOI stage timings/backlog, queue-depth gauges;
  see goworld_tpu_torch/telemetry)
- ``/trace``     — this process's finished-span ring as Chrome trace-event
  JSON (Perfetto-loadable); ``?raw=1`` returns the raw span list that
  tools/tracecat.py merges across all processes of a deployment
- ``/flight``    — the game loop's slow-tick flight recorder (last N tick
  records + the most recent over-budget dump; telemetry/tracing.py)
- ``/opmon``     — JSON dump of operation monitor stats (opmon.go:37-118;
  now a legacy view over the telemetry op_duration_seconds family)
- ``/snapshot``  — this process's cluster-plane row: the /healthz object
  plus the selected metric families the ClusterCollector aggregates
  (telemetry/collector.py)
- ``/cluster``   — the aggregated whole-deployment view, served ONLY by
  the process hosting the collector (the driver dispatcher); rendered
  live by ``python -m goworld_tpu_torch.tools.gwtop``
- ``/stack``     — all-thread stack dump (the practical subset of pprof)
- ``/profile``   — cProfile the main thread for ?seconds=S; ``&mode=torch``
  instead wraps the window in ``torch.profiler`` (CPU activity, plus the
  card's kernels when the process has used CUDA) and returns the path of
  a Chrome trace; ``&mode=jax`` (the JAX package's device trace) answers
  400 naming ``mode=torch``

SECURITY: this server is unauthenticated and serves state-changing GETs
(``/heap/start`` toggles ~2x allocation overhead process-wide) and CPU-heavy
probes. ``http_addr`` must stay LOOPBACK-BOUND (127.0.0.1) in production;
reach it remotely through an ssh tunnel, never by binding a public
interface.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
import traceback
from typing import Callable, Optional

from goworld_tpu_torch.utils import gwlog, gwvar

# /healthz detail provider: the process's service registers a zero-arg
# callable returning a JSON-able dict (kind, id, uptime, link states,
# counts). Module-level because each production process runs exactly one
# service; in-process test clusters get whichever service registered last.
_health_provider: Optional[Callable[[], dict]] = None
_module_t0 = time.monotonic()


def set_health_provider(fn: Callable[[], dict]) -> None:
    global _health_provider
    _health_provider = fn


def clear_health_provider(fn: Callable[[], dict]) -> None:
    """Unregister ``fn`` iff it is still the active provider (a service
    stopping must not wipe a newer service's registration)."""
    global _health_provider
    # == not `is`: bound methods are fresh objects per attribute access,
    # but compare equal for the same function + instance.
    if _health_provider == fn:
        _health_provider = None


def health_snapshot() -> dict:
    """The /healthz object (also embedded in /snapshot rows the cluster
    collector scrapes — telemetry/collector.py)."""
    from goworld_tpu_torch.proto.msgtypes import PROTO_VERSION

    health = {
        "status": "ok",
        "pid": os.getpid(),
        "proto_version": PROTO_VERSION,
        "uptime_s": round(time.monotonic() - _module_t0, 3),
    }
    if _health_provider is not None:
        try:
            health.update(_health_provider())
        except Exception as exc:
            health["status"] = "degraded"
            health["health_provider_error"] = str(exc)
    return health


# /cluster provider: the process hosting a ClusterCollector (the driver
# dispatcher) registers its view() here; every other process 404s with a
# pointer. Module-level for the same one-service-per-process reason as
# the health provider.
_cluster_provider: Optional[Callable[[], dict]] = None


def set_cluster_provider(fn: Callable[[], dict]) -> None:
    global _cluster_provider
    _cluster_provider = fn


def clear_cluster_provider(fn: Callable[[], dict]) -> None:
    global _cluster_provider
    if _cluster_provider == fn:
        _cluster_provider = None


def _dump_stacks() -> str:
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ---")
        out.extend(traceback.format_stack(frame))
    return "\n".join(out)


class DebugHTTPServer:
    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        gwlog.infof("debug http server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            parts = request.decode(errors="replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # Drain headers.
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
            route = path.split("?")[0]
            if route == "/profile":
                status, ctype, body = await self._profile(path)
            elif route == "/heap/types":
                status, ctype, body = await self._heap_types()
            else:
                status, ctype, body = self._route(route, self._query(path))
            head = (
                f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            )
            writer.write(head.encode() + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionResetError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _query(path: str) -> dict[str, str]:
        out: dict[str, str] = {}
        if "?" in path:
            for kv in path.split("?", 1)[1].split("&"):
                k, _, v = kv.partition("=")
                out[k] = v
        return out

    async def _profile(self, path: str) -> tuple[str, str, bytes]:
        """CPU-profile the process for ?seconds=N (pprof's /profile slot):
        cProfile runs on the main thread, so everything the game/gate/
        dispatcher loop does in the window is captured. ``&mode=torch``
        instead wraps the window in ``torch.profiler`` (see
        :meth:`_profile_torch`); ``&mode=jax`` (the JAX package's device
        trace) answers 400 naming ``mode=torch``."""
        q = self._query(path)
        seconds = 5.0
        try:
            seconds = min(60.0, max(0.1, float(q.get("seconds", "5"))))
        except ValueError:
            pass
        if q.get("mode") == "torch":
            return await self._profile_torch(seconds)
        if q.get("mode") == "jax":
            return ("400 Bad Request", "application/json", json.dumps({
                "error": "mode=jax profiles the JAX package's device; this "
                         "process runs PyTorch: ask for mode=torch",
            }).encode())
        import cProfile
        import io
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        await asyncio.sleep(seconds)
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(80)
        return "200 OK", "text/plain", buf.getvalue().encode()

    async def _profile_torch(self, seconds: float) -> tuple[str, str, bytes]:
        """On-demand device profiling: ``torch.profiler`` around an
        S-second window, CPU activity always and CUDA activity when this
        process has used the card (every kernel the AOI step launches
        lands in the trace, named, with its device time). The trace
        starts and stops here, on the loop thread, so the loop's own ops
        are recorded; its preparation runs in a thread executor first,
        because a process's first CUDA trace initialises CUPTI, which
        takes seconds on an H100 machine and would stall the loop (and
        its dispatcher heartbeats) that long. The Chrome trace is written
        from the executor into a fresh temporary directory, and the
        answer gives its path, the window and the count of device kernels
        in it. A profiler that cannot start or stop (one already running,
        no kineto) answers 500 and leaves the loop serving."""
        import tempfile

        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        trace_dir = tempfile.mkdtemp(prefix="goworld_torch_trace_")
        prof = profile(activities=activities)
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, prof.prepare_trace)
            prof.start_trace()
        except Exception as exc:
            return ("500 Internal Server Error", "application/json",
                    json.dumps({"error": f"torch.profiler did not start: "
                                         f"{exc}"}).encode())
        stop_error = None
        try:
            await asyncio.sleep(seconds)
        finally:
            try:
                prof.stop_trace()
            except Exception as exc:
                stop_error = exc
        if stop_error is not None:
            return ("500 Internal Server Error", "application/json",
                    json.dumps({"error": f"torch.profiler did not stop: "
                                         f"{stop_error}",
                                "trace_dir": trace_dir}).encode())
        trace = f"{trace_dir}/trace.json"

        def export() -> int:
            prof.export_chrome_trace(trace)
            return sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)

        kernels = await loop.run_in_executor(None, export)
        return ("200 OK", "application/json", json.dumps({
            "trace": trace,
            "trace_dir": trace_dir,
            "seconds": seconds,
            "cuda": on_card,
            "device_kernels": kernels,
            "hint": "open the trace in chrome://tracing or Perfetto",
        }).encode())

    async def _heap_types(self) -> tuple[str, str, bytes]:
        """GC census: live instance counts by type (top 40) — tells you
        WHAT is retained where tracemalloc tells you what ALLOCATED. Runs
        gc.collect() + the full gc.get_objects() walk in a THREAD EXECUTOR:
        on a large heap the census takes long enough that running it inline
        would stall the asyncio loop this process serves game/gate traffic
        on."""
        import collections as _c
        import gc as _gc

        def census() -> str:
            _gc.collect()
            counts = _c.Counter(
                type(o).__name__ for o in _gc.get_objects())
            return "\n".join(f"{n:9d}  {t}" for t, n in
                             counts.most_common(40))

        body = await asyncio.get_running_loop().run_in_executor(None, census)
        return "200 OK", "text/plain", body.encode()

    def _route(self, path: str, query: Optional[dict] = None) -> tuple[str, str, bytes]:
        if path == "/healthz":
            return ("200 OK", "application/json",
                    json.dumps(health_snapshot(), default=str).encode())
        if path == "/snapshot":
            # One compact JSON row for the cluster collector: /healthz +
            # the cluster-plane metric families (telemetry/collector.py).
            from goworld_tpu_torch.telemetry import collector

            return ("200 OK", "application/json",
                    json.dumps(collector.build_local_snapshot(),
                               default=str).encode())
        if path == "/cluster":
            if _cluster_provider is None:
                return ("404 Not Found", "application/json",
                        json.dumps({
                            "error": "no collector in this process",
                            "hint": "GET /cluster is served by the driver "
                                    "dispatcher's debug port ([telemetry] "
                                    "cluster_snapshot_interval > 0)",
                        }).encode())
            try:
                view = _cluster_provider()
            except Exception as exc:
                return ("500 Internal Server Error", "application/json",
                        json.dumps({"error": str(exc)}).encode())
            return ("200 OK", "application/json",
                    json.dumps(view, default=str).encode())
        if path == "/trace":
            from goworld_tpu_torch.telemetry import tracing

            if (query or {}).get("raw"):
                body = json.dumps({
                    "process": gwlog.get_source(),
                    "pid": os.getpid(),
                    "spans": tracing.snapshot(),
                })
            else:
                body = json.dumps(
                    tracing.export_chrome(gwlog.get_source()))
            return "200 OK", "application/json", body.encode()
        if path == "/flight":
            from goworld_tpu_torch.telemetry import tracing

            rec = tracing.flight_recorder()
            body = json.dumps(
                rec.snapshot() if rec is not None else
                {"recent": [], "last_slow": None,
                 "note": "no tick loop in this process"},
                default=str)
            return "200 OK", "application/json", body.encode()
        if path == "/history":
            from goworld_tpu_torch.telemetry import history

            w = history.active_writer()
            body = json.dumps(
                w.snapshot() if w is not None else
                {"dir": None,
                 "note": "no history writer in this process "
                         "([telemetry] history_dir unset)"},
                default=str)
            return "200 OK", "application/json", body.encode()
        if path == "/heap/start":
            # Live heap profiling (pprof's /heap slot, via tracemalloc):
            # start tracing, then GET /heap for the top Python growth
            # sites since start. ~2x alloc overhead while on; /heap/stop
            # turns it off.
            import tracemalloc

            tracemalloc.start(12)
            return "200 OK", "text/plain", b"tracemalloc started"
        if path == "/heap/stop":
            import tracemalloc

            tracemalloc.stop()
            return "200 OK", "text/plain", b"tracemalloc stopped"
        if path == "/metrics":
            from goworld_tpu_torch import telemetry

            return ("200 OK", "text/plain; version=0.0.4; charset=utf-8",
                    telemetry.render().encode())
        if path == "/heap":
            import tracemalloc

            if not tracemalloc.is_tracing():
                return ("409 Conflict", "text/plain",
                        b"not tracing; GET /heap/start first")
            snap = tracemalloc.take_snapshot()
            lines = []
            for stat in snap.statistics("traceback")[:25]:
                lines.append(f"{stat.size / 1e6:.2f} MB in "
                             f"{stat.count} blocks")
                lines.extend("    " + ln
                             for ln in stat.traceback.format()[-6:])
            return "200 OK", "text/plain", "\n".join(lines).encode()
        if path == "/vars":
            return ("200 OK", "application/json",
                    json.dumps(gwvar.snapshot(), default=str).encode())
        if path == "/opmon":
            from goworld_tpu_torch.utils import opmon

            return ("200 OK", "application/json",
                    json.dumps(opmon.dump(), default=str).encode())
        if path == "/stack":
            return "200 OK", "text/plain", _dump_stacks().encode()
        return "404 Not Found", "text/plain", b"not found"


async def setup_http_server(http_addr: str) -> Optional[DebugHTTPServer]:
    """Start the debug server if ``http_addr`` ("host:port") is configured
    (binutil.SetupHTTPServer; no-op when unset, like the reference)."""
    if not http_addr:
        return None
    host, _, port = http_addr.rpartition(":")
    srv = DebugHTTPServer(host or "127.0.0.1", int(port))
    await srv.start()
    return srv
