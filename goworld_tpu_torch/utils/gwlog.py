"""Structured logging for all framework components.

Reference parity: ``engine/gwlog/gwlog.go:16-169`` — zap-based sugar logger
with a per-component ``source`` field, level parsing, ``TraceError`` (error +
stack dump) and Fatal/Panic helpers. Here we build on the stdlib ``logging``
module with the same surface.

``[log] format = json`` switches every handler to one JSON object per line
(level/ts/source/msg) with automatic ``trace_id`` injection when the line
is emitted inside an active distributed-trace span (telemetry/tracing.py) —
so grepping a trace id across the per-process logs of a cluster yields the
exact log lines of one sampled request. The zap-parity text format stays
the default.
"""

from __future__ import annotations

import json
import logging
import sys
import traceback

_FORMAT = "%(asctime)s.%(msecs)03d %(levelname).1s %(source)s %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

_source = "goworld"
_logger = logging.getLogger("goworld_tpu_torch")
_configured = False


class _SourceFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "source"):
            record.source = _source
        return True


class _JsonFormatter(logging.Formatter):
    """One JSON object per line; trace_id injected inside active spans."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "source": getattr(record, "source", _source),
            "msg": record.getMessage(),
        }
        # Lazy import: gwlog must stay importable before telemetry (and
        # tracing itself logs through gwlog).
        try:
            from goworld_tpu_torch.telemetry import tracing

            ctx = tracing.current()
            if ctx is not None:
                obj["trace_id"] = f"{ctx.trace_id:016x}"
        except Exception:
            pass
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, separators=(",", ":"), default=str)


def set_source(source: str) -> None:
    """Set the component tag (e.g. ``game1`` / ``gate2`` / ``dispatcher1``)."""
    global _source
    _source = source


def get_source() -> str:
    """The component tag (process identity for /trace exports)."""
    return _source


def setup(level: str = "info", logfile: str | None = None,
          stderr: bool = True, fmt: str = "text") -> None:
    """Initialise handlers. Mirrors binutil.SetupGWLog (binutil.go:50-82).
    ``fmt``: "text" (zap-parity lines, default) or "json" ([log] format)."""
    global _configured
    if fmt not in ("text", "json"):
        raise ValueError(f"log format must be text|json, got {fmt!r}")
    for h in _logger.handlers:
        h.close()
    _logger.handlers.clear()
    _logger.setLevel(parse_level(level))
    _logger.propagate = False
    handlers: list[logging.Handler] = []
    if logfile:
        handlers.append(logging.FileHandler(logfile))
    if stderr or not handlers:
        handlers.append(logging.StreamHandler(sys.stderr))
    formatter = (_JsonFormatter() if fmt == "json"
                 else logging.Formatter(_FORMAT, _DATEFMT))
    for h in handlers:
        h.setFormatter(formatter)
        h.addFilter(_SourceFilter())
        _logger.addHandler(h)
    _configured = True


def parse_level(level: str) -> int:
    m = {
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warn": logging.WARNING,
        "warning": logging.WARNING,
        "error": logging.ERROR,
        "panic": logging.CRITICAL,
        "fatal": logging.CRITICAL,
    }
    try:
        return m[level.lower()]
    except KeyError:
        raise ValueError(f"unknown log level: {level!r}")


def _ensure() -> None:
    if not _configured:
        setup()


def debugf(fmt: str, *args) -> None:
    _ensure()
    _logger.debug(fmt, *args)


def infof(fmt: str, *args) -> None:
    _ensure()
    _logger.info(fmt, *args)


def warnf(fmt: str, *args) -> None:
    _ensure()
    _logger.warning(fmt, *args)


def errorf(fmt: str, *args) -> None:
    _ensure()
    _logger.error(fmt, *args)


def trace_error(fmt: str, *args) -> None:
    """Error + stack, like gwlog.TraceError (gwlog.go). Inside an ``except``
    block the active exception traceback is logged; otherwise the call stack."""
    _ensure()
    msg = fmt % args if args else fmt
    if sys.exc_info()[0] is not None:
        _logger.error("%s\n%s", msg, traceback.format_exc())
    else:
        _logger.error("%s\n%s", msg, "".join(traceback.format_stack()))


def panicf(fmt: str, *args) -> None:  # gwlint: keep — reference gwlog API (Panicf)
    _ensure()
    _logger.critical(fmt, *args)
    raise RuntimeError(fmt % args if args else fmt)


def fatalf(fmt: str, *args) -> None:  # gwlint: keep — reference gwlog API (Fatalf)
    _ensure()
    _logger.critical(fmt, *args)
    sys.exit(1)
