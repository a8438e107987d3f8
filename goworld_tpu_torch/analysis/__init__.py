"""Engine-aware static analysis (gwlint) + runtime lock-order detection.

Two halves, one goal — turn the hand-written invariants the test oracles
keep re-discovering into machine-checked properties:

- ``gwlint`` (core.py + rules.py): an AST rule engine run over the whole
  package by tier-1 (``tools/gwlint.py`` locally).  Seven engine-specific
  rules — jit hygiene, hot-path shape, parse bounds, lock discipline,
  telemetry hygiene, config-key drift, and wire-proto conformance
  against the declarative schema in proto/schema.py (R7, with a pinned
  schema digest per PROTO_VERSION) — plus a symbol-reachability pass
  for dead code.  Violations are suppressed only through the committed
  ``gwlint_baseline.toml`` (every entry carries a justification) or an
  inline ``# gwlint: ok RN reason`` pragma, so the gate starts green and
  *ratchets*: new code can only add violations by editing the baseline
  in review.
- ``lockgraph``: an opt-in instrumented Lock wrapper recording the
  cross-thread acquisition-order graph at runtime (the dynamic
  complement to rule R4), asserted acyclic — and free of blocking calls
  under a held lock — by tier-1 over the chaos and stress smokes.
- ``modelcheck``: an explicit-state model checker for the cluster
  protocol — the dispatcher/game/gate state machines (migrate target
  states, grace windows, sync parking, boot buffering, gate-binding
  generations) explored exhaustively over bounded interleavings of
  delivery, crash, cold restart and grace expiry, asserting the
  zero-loss invariants; failing interleavings print as readable message
  traces.  The model is the spec a protocol change extends first.
"""

from goworld_tpu_torch.analysis.core import (
    Violation,
    LintResult,
    load_baseline,
    run_lint,
)
from goworld_tpu_torch.analysis.lockgraph import LockGraphMonitor


def hot_path(fn):
    """Mark a function as being on a per-tick hot path.

    gwlint's R2 (hot-path shape) checks every function carrying this
    decorator — beside the config-listed allowset in rules.py — for
    per-item Python loops over entity-sized iterables and per-record
    ``struct.pack``.  Runtime cost: one attribute write at import.
    """
    fn.__gwlint_hot_path__ = True
    return fn


__all__ = [
    "Violation",
    "LintResult",
    "load_baseline",
    "run_lint",
    "LockGraphMonitor",
    "hot_path",
]
