"""Post-mortem bundles: one directory holding a whole cluster's black box.

A bundle is emitted on abnormal exit, chaos failure, or an explicit
``tools/gwpost.py`` run, and collects per process: the on-disk history
ring (telemetry/history.py — survives the process), the span ring and
flight dump (when the process was alive to ask), plus the final
``GET /cluster`` aggregate. Layout::

    <bundle>/
      MANIFEST.json                 {v, reason, created, processes}
      cluster.json                  final /cluster view (when available)
      processes/<name>/history/seg-*  copied history ring segments
      processes/<name>/spans.json     raw span-ring dump (live scrape)
      processes/<name>/flight.json    flight-recorder dump (live scrape)

Rendering reuses tracecat's Perfetto merge (:func:`merge_spans` is the
shared implementation tools/tracecat.py delegates to): every process's
spans — including spans *synthesized from the dead process's
flight-recorder rows in its history ring* — become one merged
chrome://tracing / Perfetto timeline. That last part is the point of the
whole exercise: the killed game's final ticks, which no live endpoint
can serve anymore, come back out of its black box.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

from goworld_tpu_torch.telemetry import history as history_mod

MANIFEST_NAME = "MANIFEST.json"


# --- flight rows → span dicts -------------------------------------------------

def flight_ticks_to_spans(ticks: list[dict]) -> list[dict]:
    """Synthesize span dicts (telemetry/tracing.py shape) from
    flight-recorder tick rows: one ``tick.total`` span per row carrying
    the row's extras (entities, queue_depth, ...) as args, plus one
    ``tick.<phase>`` child per phase laid out as consecutive intervals —
    the same layout record_phase_spans uses for sampled ticks."""
    spans: list[dict] = []
    sid = 0
    for t in ticks:
        ts = float(t.get("ts", 0.0))
        total = float(t.get("total_ms", 0.0)) / 1000.0
        sid += 1
        root = sid
        args = {k: v for k, v in t.items()
                if k not in ("ts", "total_ms", "phases_ms")}
        spans.append({"name": "tick.total", "ts": ts, "dur": total,
                      "trace": 0, "span": root, "parent": 0,
                      "args": args})
        at = ts
        for ph, ms in (t.get("phases_ms") or {}).items():
            if ph == "total":
                continue
            sid += 1
            spans.append({"name": f"tick.{ph}", "ts": at,
                          "dur": float(ms) / 1000.0, "trace": 0,
                          "span": sid, "parent": root})
            at += float(ms) / 1000.0
    return spans


# --- the Perfetto merge (tracecat's, shared) ---------------------------------

def merge_spans(process_spans: list[tuple[str, list[dict]]],
                trace_id: Optional[int] = None) -> dict:
    """Merge per-process span lists into one chrome trace-event object —
    the implementation behind tools/tracecat.py's ``merge`` (pid is the
    list index, so re-running yields comparable files)."""
    from goworld_tpu_torch.telemetry.tracing import chrome_events

    events: list[dict] = []
    for pid, (name, spans) in enumerate(process_spans, start=1):
        if trace_id is not None:
            spans = [s for s in spans if s["trace"] == trace_id]
        events.extend(chrome_events(spans, name, pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --- collection ---------------------------------------------------------------

def collect_bundle(out_dir: str, *, reason: str = "",
                   history_dir: Optional[str] = None,
                   cluster_view: Optional[dict] = None,
                   process_spans: Optional[dict[str, list[dict]]] = None,
                   flights: Optional[dict[str, dict]] = None) -> dict:
    """Assemble a bundle directory. ``history_dir`` is the configured
    ``[telemetry] history_dir`` root (one subdirectory per process —
    copied verbatim, torn tails and all); ``process_spans`` / ``flights``
    are live scrapes keyed by process name (dead processes simply have
    none — their history ring speaks for them). Returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    names: set[str] = set()

    def proc_dir(name: str) -> str:
        d = os.path.join(out_dir, "processes", name)
        os.makedirs(d, exist_ok=True)
        names.add(name)
        return d

    if history_dir and os.path.isdir(history_dir):
        for name in sorted(os.listdir(history_dir)):
            src = os.path.join(history_dir, name)
            if not os.path.isdir(src):
                continue
            segs = history_mod.list_segments(src)
            if not segs:
                continue
            dst = os.path.join(proc_dir(name), "history")
            os.makedirs(dst, exist_ok=True)
            for seg in segs:
                shutil.copy2(seg, dst)
    for name, spans in (process_spans or {}).items():
        with open(os.path.join(proc_dir(name), "spans.json"), "w",
                  encoding="utf-8") as f:
            json.dump(spans, f, separators=(",", ":"))
    for name, flight in (flights or {}).items():
        with open(os.path.join(proc_dir(name), "flight.json"), "w",
                  encoding="utf-8") as f:
            json.dump(flight, f, separators=(",", ":"))
    if cluster_view is not None:
        with open(os.path.join(out_dir, "cluster.json"), "w",
                  encoding="utf-8") as f:
            json.dump(cluster_view, f, separators=(",", ":"))
    manifest = {
        "v": 1,
        "reason": reason,
        "created": round(time.time(), 3),
        "processes": sorted(names),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    return manifest


# --- loading / rendering ------------------------------------------------------

def _read_json(path: str) -> Any:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_bundle(dir: str) -> dict:
    """Parse a bundle back: manifest, cluster view, and per process the
    history frames (torn tails tolerated + counted), raw spans, and
    flight dump — whichever of those the bundle holds."""
    out: dict = {
        "manifest": _read_json(os.path.join(dir, MANIFEST_NAME)) or {},
        "cluster": _read_json(os.path.join(dir, "cluster.json")),
        "processes": {},
    }
    proc_root = os.path.join(dir, "processes")
    if os.path.isdir(proc_root):
        for name in sorted(os.listdir(proc_root)):
            pdir = os.path.join(proc_root, name)
            if not os.path.isdir(pdir):
                continue
            frames, truncated = history_mod.read_frames(
                os.path.join(pdir, "history"))
            out["processes"][name] = {
                "frames": frames,
                "truncated": truncated,
                "spans": _read_json(os.path.join(pdir, "spans.json")),
                "flight": _read_json(os.path.join(pdir, "flight.json")),
            }
    return out


def bundle_process_spans(dir: str) -> list[tuple[str, list[dict]]]:
    """Per-process span lists from a bundle, merge-ready: the scraped
    span ring (when present) plus spans synthesized from every
    flight-recorder row the process's history frames carry — the dead
    process's final ticks land on the timeline through the latter."""
    loaded = load_bundle(dir)
    out: list[tuple[str, list[dict]]] = []
    for name, proc in loaded["processes"].items():
        spans = list(proc["spans"] or [])
        ticks: list[dict] = []
        for frame in proc["frames"]:
            ticks.extend(frame.get("flight") or [])
        if not ticks and proc["flight"]:
            ticks = list(proc["flight"].get("recent") or [])
        spans.extend(flight_ticks_to_spans(ticks))
        if spans:
            out.append((name, spans))
    return out


def bundle_summary(dir: str) -> dict:
    """Compact stdout object for gwpost: what the bundle holds."""
    loaded = load_bundle(dir)
    procs = {}
    for name, proc in loaded["processes"].items():
        ticks = sum(len(f.get("flight") or []) for f in proc["frames"])
        procs[name] = {
            "frames": len(proc["frames"]),
            "truncated_tails": proc["truncated"],
            "final_frame": bool(proc["frames"]
                                and proc["frames"][-1].get("final")),
            "flight_ticks": ticks,
            "spans": len(proc["spans"] or []),
        }
    cluster = loaded["cluster"] or {}
    summary = (cluster.get("summary") or {})
    return {
        "reason": loaded["manifest"].get("reason"),
        "processes": procs,
        "cluster": {
            "present": loaded["cluster"] is not None,
            "alerts": summary.get("alerts"),
            "slo": (summary.get("slo") or {}).get("ok"),
        },
    }
