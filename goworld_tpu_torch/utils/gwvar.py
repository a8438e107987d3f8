"""Process-wide published variables.

Reference parity: ``engine/gwvar/gwvar.go:5-29`` — expvar-backed flags
(IsDeploymentReady) served on the debug HTTP port. Python-native design: a
registry of names → value-or-callable, JSON-serialized by the debug HTTP
server (utils/debug_http.py) at ``/vars``.
"""

from __future__ import annotations

from typing import Any

_vars: dict[str, Any] = {}


def set_var(name: str, value: Any) -> None:
    """Publish a value (or a zero-arg callable evaluated at read time)."""
    _vars[name] = value


def get_var(name: str, default: Any = None) -> Any:  # gwlint: keep — accessor beside set/unset
    v = _vars.get(name, default)
    return v() if callable(v) else v


def unset(name: str) -> None:
    """Remove a published variable (stopped services must not serve stale
    probes or keep themselves alive through closure captures)."""
    _vars.pop(name, None)


def snapshot() -> dict[str, Any]:
    out = {}
    for name, v in _vars.items():
        try:
            out[name] = v() if callable(v) else v
        except Exception as exc:  # a broken probe must not kill /vars
            out[name] = f"<error: {exc}>"
    return out


def clear_for_tests() -> None:
    _vars.clear()


# The one variable the reference always publishes (gwvar.go:27-29).
set_var("IsDeploymentReady", False)
