#!/usr/bin/env python
"""gwlint — engine-aware static analysis over goworld_tpu_torch/.

Runs the seven AST rules (R1 sync hygiene, R2 hot-path shape, R3
parse-bounds, R4 lock discipline, R5 telemetry hygiene, R6 config-key
drift, R7 proto-conformance + wire-schema digest pin) against the whole
package and reports anything not suppressed by the committed baseline
(``goworld_tpu_torch/analysis/gwlint_baseline.toml``) or an inline
``# gwlint: ok RN reason`` pragma.  Exit code 1 on unsuppressed
violations — the same check tests/test_torch_analysis.py runs.

Usage (``python -m goworld_tpu_torch.tools.gwlint`` takes the same flags):
    python goworld_tpu_torch/tools/gwlint.py
        lint, apply the baseline
    ... --no-baseline        raw findings
    ... --rules R3,R4        a subset of rules
    ... --write-baseline     snapshot current findings (reasons say
                             TRIAGE — edit them!)
    ... --dead-code          reachability report: unreferenced defs and
                             unused imports
    ... --strict-baseline    also fail on stale baseline entries
"""

from __future__ import annotations

import argparse
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)

from goworld_tpu_torch.analysis import core  # noqa: E402
from goworld_tpu_torch.analysis import reach  # noqa: E402

DEFAULT_BASELINE = core.DEFAULT_BASELINE


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--no-baseline", action="store_true",
                    help="report raw findings, ignoring the baseline")
    ap.add_argument("--rules", default="",
                    help="comma-separated subset (default: all seven)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write every current finding to the baseline "
                         "with a TRIAGE placeholder reason")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="fail on stale baseline entries too")
    ap.add_argument("--dead-code", action="store_true",
                    help="run the symbol-reachability pass instead")
    args = ap.parse_args(argv)

    if args.dead_code:
        modules = core.parse_package(REPO_ROOT)
        dead = reach.find_dead_code(REPO_ROOT, modules)
        for d in dead:
            print(d.render())
        print(f"gwlint --dead-code: {len(dead)} candidate(s) "
              f"(review before deleting; name-based reachability)")
        return 0

    rules = tuple(r.strip() for r in args.rules.split(",") if r.strip()) \
        or None
    baseline = None if (args.no_baseline or args.write_baseline) else (
        args.baseline if os.path.exists(args.baseline) else None)
    result = core.run_lint(REPO_ROOT, baseline_path=baseline, rules=rules)

    if args.write_baseline:
        entries = []
        seen = set()
        for v in result.violations:
            if v.key in seen:
                continue
            seen.add(v.key)
            entries.append(core.Suppression(
                v.rule, v.path, v.symbol,
                f"TRIAGE: {v.message[:120]}"))
        with open(args.baseline, "w", encoding="utf-8") as f:
            f.write(core.format_baseline(entries))
        print(f"wrote {len(entries)} entries to {args.baseline} — "
              f"replace every TRIAGE reason with a real justification")
        return 0

    print(result.render())
    if result.violations:
        return 1
    if args.strict_baseline and result.stale_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
