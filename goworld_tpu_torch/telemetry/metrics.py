"""Typed metric registry: Counter / Gauge / Histogram families + exposition.

The observability core every goworld_tpu process shares (game, gate,
dispatcher, bench). Zero-dep (stdlib only) and allocation-light on the hot
path: recording a sample is one lock acquisition plus integer/float updates
on preallocated slots — no per-observation allocation, no string formatting.
Exposition cost (Prometheus text render, JSON snapshot) is paid by the
*reader* on the debug HTTP port, never by the recording loop.

Design notes:

- Metrics are **families**: a name plus a fixed tuple of label names, with
  one child per label-value combination (``family.labels("dispatch")``).
  An unlabeled metric is a family with one implicit child; the registry
  returns the child directly so call sites stay one-liners.
- Get-or-create semantics: re-registering the same name returns the
  existing family (services are constructed repeatedly in tests), but a
  kind or label-schema mismatch raises — two subsystems silently sharing
  one name with different meanings is the bug this catches.
- Histograms use **fixed exponential buckets** (default 0.1 ms → ~26 s,
  factor 2): cumulative bucket counts are computed at render time, so
  ``observe`` touches exactly one bucket slot. A bounded sample ring
  additionally yields live p50/p99 (the opmon shim's percentile contract —
  utils/opmon.py predates this module and now feeds it).
- Gauges accept either a value (``set``) or a zero-arg callable
  (``set_function``) evaluated at collection time — queue depths and
  backlog sizes are pull-sampled, costing the hot loop nothing.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Callable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_RING = 512  # bounded per-histogram sample ring for live percentiles


def exponential_buckets(start: float, factor: float, count: int) -> tuple[float, ...]:
    """``count`` upper bounds starting at ``start``, each ``factor`` apart."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out = []
    v = start
    for _ in range(count):
        out.append(v)
        v *= factor
    return tuple(out)


# 0.1 ms .. ~26 s: spans a 5 ms loop tick through a 10+ s jit compile.
DEFAULT_BUCKETS = exponential_buckets(0.0001, 2.0, 19)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral values render as integers."""
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    """Monotonic counter child. ``inc`` only — decreasing raises."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value child; ``set_function`` makes it pull-sampled."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._fn = None
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate ``fn`` at every collection instead of storing a value
        (queue depths, backlog sizes — zero hot-loop cost)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")  # a broken probe must not kill /metrics
        return self._value


class Histogram:
    """Fixed-bucket histogram child with count/sum/max and a bounded
    sample ring for live p50/p99 (nearest-rank, opmon parity)."""

    __slots__ = ("_lock", "_bounds", "_bucket_counts", "_count", "_sum",
                 "_max", "_ring", "_ring_i")

    def __init__(self, bounds: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self._bounds = tuple(bounds)
        self._bucket_counts = [0] * (len(self._bounds) + 1)  # +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._ring: list[float] = []
        self._ring_i = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self._bounds, v)  # le-inclusive upper bound
        with self._lock:
            self._bucket_counts[i] += 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            if len(self._ring) < _RING:
                self._ring.append(v)
            else:
                self._ring[self._ring_i] = v
                self._ring_i = (self._ring_i + 1) % _RING

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the bounded ring: ceil(q*n)-1, NOT
        int(q*n) — the latter returns the max (p100) for n in 100..101 and
        overstates p99 generally (carried over from opmon). Rank arithmetic
        is integer per-mille so p999 is distinct from p99 and no float-ceil
        precision leaks in (0.95 * 100 is not 95 in binary)."""
        with self._lock:
            s = sorted(self._ring)
        if not s:
            return 0.0
        q1000 = int(round(q * 1000))
        return s[max(0, -(-len(s) * q1000 // 1000) - 1)]

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """[(upper_bound, cumulative_count)], ending with (+Inf, count)."""
        with self._lock:
            counts = list(self._bucket_counts)
        out = []
        acc = 0
        for bound, c in zip(self._bounds, counts):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out


class MetricFamily:
    """One named metric: fixed label schema, one child per value tuple."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str],
                 buckets: Optional[Sequence[float]] = None) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.kind = kind  # counter | gauge | histogram
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets) if buckets is not None else None
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def _new_child(self) -> Any:
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self._buckets or DEFAULT_BUCKETS)

    def labels(self, *values: str, **kv: str) -> Any:
        """The child for one label-value combination (cached). Accepts
        positional values in labelname order or keyword form."""
        if kv:
            if values:
                raise ValueError("pass labels positionally OR by keyword")
            try:
                values = tuple(str(kv[ln]) for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r}"
                ) from None
            if len(kv) != len(self.labelnames):
                extra = set(kv) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown labels {sorted(extra)}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label values "
                f"({self.labelnames}), got {len(values)}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def remove(self, *values: str) -> None:
        """Drop one child (stopped services must not keep themselves alive
        through gauge closures — same reasoning as gwvar.unset)."""
        with self._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    def clear(self) -> None:
        with self._lock:
            self._children.clear()

    def children(self) -> list[tuple[tuple[str, ...], Any]]:
        with self._lock:
            return list(self._children.items())


class Registry:
    """name → MetricFamily, with get-or-create typed constructors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, help: str, kind: str,
                       labelnames: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> Any:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = MetricFamily(
                    name, help, kind, labelnames, buckets
                )
            else:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}, "
                        f"not {kind}"
                    )
                if fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {labelnames}"
                    )
        if not labelnames:
            return fam.labels()  # unlabeled: hand back the single child
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Any:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Any:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Any:
        return self._get_or_create(name, help, "histogram", labelnames, buckets)

    def family(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    # --- exposition ---------------------------------------------------------

    def _families_snapshot(self) -> list[MetricFamily]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for fam in self._families_snapshot():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in fam.children():
                base = "".join(
                    f'{ln}="{_escape_label(lv)}",'
                    for ln, lv in zip(fam.labelnames, values)
                )
                if fam.kind == "histogram":
                    for bound, cum in child.cumulative_buckets():
                        le = "+Inf" if bound == float("inf") else _fmt(bound)
                        lines.append(
                            f'{fam.name}_bucket{{{base}le="{le}"}} {cum}'
                        )
                    sfx = f"{{{base[:-1]}}}" if base else ""
                    lines.append(f"{fam.name}_sum{sfx} {_fmt(child.sum)}")
                    lines.append(f"{fam.name}_count{sfx} {child.count}")
                    lines.append(
                        f"{fam.name}_p999{sfx} "
                        f"{_fmt(child.percentile(0.999))}"
                    )
                else:
                    sfx = f"{{{base[:-1]}}}" if base else ""
                    lines.append(f"{fam.name}{sfx} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able structured dump (the ``/opmon`` superset: every family,
        every series; histograms carry count/avg/max/p50/p95/p99/p999)."""
        out: dict = {}
        for fam in self._families_snapshot():
            series = []
            for values, child in fam.children():
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    cnt = child.count
                    series.append({
                        "labels": labels,
                        "count": cnt,
                        "sum": child.sum,
                        "avg": child.sum / cnt if cnt else 0.0,
                        "max": child.max,
                        "p50": child.percentile(0.50),
                        "p95": child.percentile(0.95),
                        "p99": child.percentile(0.99),
                        "p999": child.percentile(0.999),
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out


#: The process-wide default registry every subsystem records into and the
#: debug HTTP ``/metrics`` route renders from.
REGISTRY = Registry()
