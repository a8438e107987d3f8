"""SLO plane: declarative budgets judged continuously over /cluster.

The chaos matrix and the floor gates judge point-in-time numbers; an
operator (and CheetahGIS-style streaming pipelines, PAPERS.md) needs a
*continuously evaluated* verdict: is the cluster inside its latency and
correctness budgets right now, and how fast is it burning its error
budget? This module turns the ``[slo]`` config section
(:class:`~goworld_tpu_torch.config.read_config.SLOConfig`) into that verdict:

- :func:`observe` extracts the budgeted observables from the
  ClusterCollector's per-process rows (tick p99, delivery p99,
  steady-state retraces — the same snapshot series gwtop renders).
- :class:`SLOJudge` judges one poll at a time, keeping bounded windows of
  verdicts per budget and deriving **compliance** (fraction of polls in
  budget over the long window) and **multi-window burn rate**
  (violation_rate / error_budget over a short page-now window and the
  long trend window — the SRE convention: burn 1.0 = exactly spending
  the budget, >1 = on course to exhaust it).
- :func:`judge_values` is the one-shot form for batch gates
  (``run_scenario``, the chaos harness) that already hold the observed
  numbers: returns per-budget verdicts, raises nothing — callers raise
  :class:`SLOViolation` with the rendered verdict when they want a hard
  failure.
"""

from __future__ import annotations

import collections
from typing import Any, Optional


class SLOViolation(RuntimeError):
    """A configured SLO budget was exceeded by a gated run."""


def _hist_stat_max(metrics: dict[str, Any], family: str, label: str,
                   value: str, stat: str) -> Optional[float]:
    """Max of one histogram stat across matching series (None = no data)."""
    fam = metrics.get(family)
    if not fam:
        return None
    best: Optional[float] = None
    for s in fam["series"]:
        if s["labels"].get(label) != value or not s.get("count"):
            continue
        v = s.get(stat)
        if v is None:
            continue
        best = v if best is None else max(best, v)
    return best


def _series_sum(metrics: dict[str, Any], family: str) -> float:
    fam = metrics.get(family)
    if not fam:
        return 0.0
    return sum(float(s.get("value", 0.0)) for s in fam["series"])


def observe(processes: dict[str, dict[str, Any]]) -> dict[str, Any]:
    """The budgeted observables from ClusterCollector process rows:
    worst (max) game tick p99 and delivery (sync_send phase) p99 across
    reporting games, and steady-state retraces summed cluster-wide.
    None = no data yet (not a violation)."""
    tick: Optional[float] = None
    delivery: Optional[float] = None
    retraces = 0.0
    for row in processes.values():
        m = row.get("metrics") or {}
        t = _hist_stat_max(
            m, "game_tick_phase_seconds", "phase", "total", "p99")
        if t is not None:
            tick = t if tick is None else max(tick, t)
        d = _hist_stat_max(
            m, "game_tick_phase_seconds", "phase", "sync_send", "p99")
        if d is not None:
            delivery = d if delivery is None else max(delivery, d)
        retraces += _series_sum(m, "jit_retrace_events_total")
    return {
        "tick_p99": tick,
        "delivery_p99": delivery,
        "steady_state_retraces": retraces,
    }


def _budget_specs(slo) -> list[tuple[str, Optional[float]]]:
    return [
        ("tick_p99", slo.tick_p99_budget),
        ("delivery_p99", slo.delivery_p99_budget),
        ("steady_state_retraces",
         None if slo.steady_state_retraces is None
         else float(slo.steady_state_retraces)),
    ]


def judge_values(slo, *, tick_p99: Optional[float] = None,
                 delivery_p99: Optional[float] = None,
                 bot_error_rate: Optional[float] = None,
                 steady_state_retraces: Optional[float] = None
                 ) -> dict[str, Any]:
    """One-shot verdict for batch gates holding observed values directly
    (run_scenario / chaos). ``{"ok": bool, "budgets": {name: {...}}}`` —
    only configured budgets appear; observed None = no data = in budget."""
    observed = {
        "tick_p99": tick_p99,
        "delivery_p99": delivery_p99,
        "bot_error_rate": bot_error_rate,
        "steady_state_retraces": steady_state_retraces,
    }
    specs = _budget_specs(slo) + [("bot_error_rate", slo.bot_error_rate)]
    budgets: dict[str, Any] = {}
    ok_all = True
    for name, budget in specs:
        if budget is None:
            continue
        obs = observed.get(name)
        violated = obs is not None and obs > budget
        budgets[name] = {"budget": budget, "observed": obs,
                         "ok": not violated}
        ok_all = ok_all and not violated
    return {"ok": ok_all, "budgets": budgets}


def render_verdict(verdict: dict[str, Any]) -> str:
    """Human line for logs / SLOViolation messages."""
    parts = []
    for name, b in verdict["budgets"].items():
        obs = b["observed"]
        obs_s = "n/a" if obs is None else f"{obs:.6g}"
        mark = "OK" if b["ok"] else "VIOLATED"
        parts.append(f"{name}={obs_s} (budget {b['budget']:.6g}) {mark}")
    return "; ".join(parts) if parts else "no budgets configured"


class SLOJudge:
    """Per-poll SLO evaluation with bounded burn-rate windows.

    The driver dispatcher's ClusterCollector owns one of these and calls
    :meth:`judge_poll` every scrape round; ``view()`` ships
    :meth:`summary` as ``summary["slo"]`` and appends :meth:`alerts`.
    """

    def __init__(self, slo) -> None:
        self.slo = slo
        self._windows: dict[str, collections.deque] = {}
        self._polls = 0
        self._last: dict[str, Any] = {
            "enabled": slo.enabled(), "ok": True, "polls": 0, "budgets": {},
        }

    def judge_poll(self, processes: dict[str, dict[str, Any]]) -> dict:
        obs = observe(processes)
        budgets: dict[str, Any] = {}
        ok_all = True
        self._polls += 1
        for name, budget in _budget_specs(self.slo):
            if budget is None:
                continue
            observed = obs.get(name)
            violated = observed is not None and observed > budget
            win = self._windows.setdefault(
                name,
                collections.deque(maxlen=max(1, self.slo.burn_long_polls)))
            win.append(1 if violated else 0)
            short = list(win)[-max(1, self.slo.burn_short_polls):]
            rate_short = sum(short) / len(short)
            rate_long = sum(win) / len(win)
            eb = self.slo.error_budget
            budgets[name] = {
                "budget": budget,
                "observed": observed,
                "ok": not violated,
                "compliance": round(1.0 - rate_long, 4),
                "burn_short": round(rate_short / eb, 2),
                "burn_long": round(rate_long / eb, 2),
            }
            ok_all = ok_all and not violated
        if self.slo.bot_error_rate is not None:
            # Declared for completeness: no cluster metric carries bot
            # errors — chaos/bench gates judge this budget directly.
            budgets["bot_error_rate"] = {
                "budget": self.slo.bot_error_rate,
                "observed": None,
                "ok": True,
                "note": "judged by chaos/bench gates",
            }
        self._last = {
            "enabled": True,
            "ok": ok_all,
            "polls": self._polls,
            "error_budget": self.slo.error_budget,
            "windows": {"short_polls": self.slo.burn_short_polls,
                        "long_polls": self.slo.burn_long_polls},
            "budgets": budgets,
        }
        return self._last

    def summary(self) -> dict[str, Any]:
        return self._last

    def alerts(self) -> list[str]:
        out = []
        for name, b in self._last.get("budgets", {}).items():
            if not b.get("ok", True):
                out.append(
                    f"SLO {name} out of budget: {b['observed']:.6g} > "
                    f"{b['budget']:.6g} (burn {b.get('burn_short', 0):.1f}x "
                    f"short / {b.get('burn_long', 0):.2f}x long)")
            elif b.get("burn_long", 0) >= 1.0:
                out.append(
                    f"SLO {name} burning error budget: "
                    f"{b['burn_long']:.2f}x over the long window")
        return out
