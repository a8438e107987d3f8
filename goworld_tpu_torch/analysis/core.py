"""gwlint core: file model, suppression mechanics, baseline, runner.

The engine is deliberately self-contained (ast + stdlib only — the image
has no tomllib/tomli, so the baseline file is read by a minimal TOML-subset
parser below).  Rules live in rules.py; this module owns everything a rule
needs to report a finding and everything the gate needs to decide whether
a finding is suppressed:

- **Inline pragma**: ``# gwlint: ok R3 reason text`` on the offending line
  suppresses that rule there.  A pragma without a reason does NOT count —
  the whole point is that every suppression is justified in-place.
- **Baseline** (``goworld_tpu_torch/analysis/gwlint_baseline.toml``,
  ``DEFAULT_BASELINE``; the repo root's ``gwlint_baseline.toml`` belongs
  to the JAX package): entries keyed by
  ``(rule, path, symbol)`` — symbol is the dotted enclosing scope, e.g.
  ``SlabStore.pack_sync`` or ``<module>`` — each with a mandatory
  ``reason``.  Symbol keys (not line numbers) keep the baseline stable
  across unrelated edits.  ``run_lint`` reports stale entries so the
  baseline only ever shrinks outside review.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import tokenize
from typing import Iterable, Optional

#: Rules shipped with the engine (rules.py registers one checker per id).
RULE_IDS = ("R1", "R2", "R3", "R4", "R5", "R6", "R7")

#: The port's committed baseline, kept inside the package.
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "gwlint_baseline.toml")

_PRAGMA_RE = re.compile(r"#\s*gwlint:\s*ok\s+(R\d)\b[\s:,\u2014-]*(.*)")


@dataclasses.dataclass
class Violation:
    rule: str
    path: str  # repo-relative posix path
    line: int
    symbol: str  # dotted enclosing scope ("<module>" at module level)
    message: str
    end_line: int = 0  # last line of the flagged node (0: ``line``)

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: "
                f"{self.message}")


@dataclasses.dataclass
class Suppression:
    rule: str
    path: str
    symbol: str  # "" or "*" matches any symbol in the file
    reason: str
    used: int = 0

    def matches(self, v: Violation) -> bool:
        if self.rule != v.rule or self.path != v.path:
            return False
        return self.symbol in ("", "*") or self.symbol == v.symbol


class ParsedModule:
    """One source file: AST + raw lines + inline-pragma map."""

    def __init__(self, root: str, path: str) -> None:
        self.abspath = path
        self.path = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "rb") as f:
            raw = f.read()
        self.source = raw.decode("utf-8", errors="replace")
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.path)
        # line -> {rule: reason} from "# gwlint: ok RN reason" comments.
        self.pragmas: dict[int, dict[str, str]] = {}
        self._scan_pragmas(raw)
        self._scopes: Optional[list[tuple[int, int, str]]] = None

    def _scan_pragmas(self, raw: bytes) -> None:
        try:
            tokens = tokenize.tokenize(iter(raw.splitlines(True)).__next__)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA_RE.search(tok.string)
                if m and m.group(2).strip():
                    self.pragmas.setdefault(tok.start[0], {})[
                        m.group(1)] = m.group(2).strip()
        except tokenize.TokenError:
            pass  # half-written file: pragma scan is best-effort

    # -- symbol attribution --------------------------------------------------

    def _build_scopes(self) -> list[tuple[int, int, str]]:
        spans: list[tuple[int, int, str]] = []

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    name = f"{prefix}.{child.name}" if prefix else child.name
                    end = getattr(child, "end_lineno", child.lineno)
                    spans.append((child.lineno, end or child.lineno, name))
                    visit(child, name)
                else:
                    visit(child, prefix)

        visit(self.tree, "")
        return spans

    def symbol_at(self, line: int) -> str:
        """Dotted enclosing def/class scope of a line (innermost wins)."""
        if self._scopes is None:
            self._scopes = self._build_scopes()
        best = "<module>"
        best_size = 1 << 30
        for lo, hi, name in self._scopes:
            if lo <= line <= hi and (hi - lo) < best_size:
                best, best_size = name, hi - lo
        return best

    def violation(self, rule: str, node_or_line, message: str) -> Violation:
        line = getattr(node_or_line, "lineno", node_or_line)
        end = getattr(node_or_line, "end_lineno", None) or line
        return Violation(rule, self.path, line, self.symbol_at(line),
                         message, end)


# --- baseline: minimal TOML subset ------------------------------------------
#
# The image ships neither tomllib (py3.10) nor tomli, so the baseline is
# parsed here.  Accepted grammar — exactly what the writer below emits:
#   [[suppress]]
#   rule = "R3"
#   path = "goworld_tpu_torch/netutil/rudp.py"
#   symbol = "RUDPConnection._on_segment"   # optional ("" / "*" = any)
#   reason = "why this is fine"
# Blank lines and full-line comments are ignored; values are basic strings.

_KEY_RE = re.compile(r'^([A-Za-z_][A-Za-z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*(?:#.*)?$')


def _unescape(s: str) -> str:
    return (s.replace('\\"', '"').replace("\\\\", "\\")
            .replace("\\n", "\n").replace("\\t", "\t"))


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def load_baseline(path: str) -> list[Suppression]:
    entries: list[Suppression] = []
    cur: Optional[dict[str, str]] = None

    def flush() -> None:
        nonlocal cur
        if cur is None:
            return
        missing = [k for k in ("rule", "path", "reason") if not cur.get(k)]
        if missing:
            raise ValueError(
                f"{path}: [[suppress]] entry at end of block missing "
                f"required key(s) {missing} — every suppression needs a "
                f"rule, a path, and a non-empty justification")
        entries.append(Suppression(cur["rule"], cur["path"],
                                   cur.get("symbol", ""), cur["reason"]))
        cur = None

    with open(path, encoding="utf-8") as f:
        for ln, rawline in enumerate(f, 1):
            line = rawline.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[suppress]]":
                flush()
                cur = {}
                continue
            m = _KEY_RE.match(line)
            if m:
                if cur is None:
                    raise ValueError(
                        f"{path}:{ln}: key outside a [[suppress]] block")
                cur[m.group(1)] = _unescape(m.group(2))
                continue
            raise ValueError(f"{path}:{ln}: unparseable line {line!r} "
                             f"(gwlint reads a strict TOML subset)")
    flush()
    return entries


def format_baseline(entries: Iterable[Suppression]) -> str:
    out = ["# gwlint suppression baseline — every entry records ONE known",
           "# violation with a justification.  The tier-1 gate fails on any",
           "# violation NOT matched here, so this file only changes in",
           "# review: fix the finding, or add an entry explaining why not.",
           ""]
    for e in entries:
        out.append("[[suppress]]")
        out.append(f'rule = "{_escape(e.rule)}"')
        out.append(f'path = "{_escape(e.path)}"')
        if e.symbol:
            out.append(f'symbol = "{_escape(e.symbol)}"')
        out.append(f'reason = "{_escape(e.reason)}"')
        out.append("")
    return "\n".join(out)


# --- runner -----------------------------------------------------------------


@dataclasses.dataclass
class LintResult:
    violations: list[Violation]  # unsuppressed
    suppressed: list[Violation]
    stale_baseline: list[Suppression]
    modules: list[ParsedModule]

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        lines = [v.render() for v in self.violations]
        lines.append(f"gwlint: {len(self.violations)} violation(s), "
                     f"{len(self.suppressed)} suppressed, "
                     f"{len(self.stale_baseline)} stale baseline entrie(s)")
        for s in self.stale_baseline:
            lines.append(f"  stale baseline: {s.rule} {s.path} "
                         f"{s.symbol or '*'} ({s.reason})")
        return "\n".join(lines)


def iter_py_files(root: str, subdir: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, subdir)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def parse_package(root: str, subdirs: Iterable[str] = ("goworld_tpu_torch",)
                  ) -> list[ParsedModule]:
    return [ParsedModule(root, p)
            for sub in subdirs for p in iter_py_files(root, sub)]


def run_lint(root: str, baseline_path: Optional[str] = None,
             rules: Optional[Iterable[str]] = None,
             modules: Optional[list[ParsedModule]] = None) -> LintResult:
    """Lint ``goworld_tpu_torch/`` under ``root`` and fold in suppressions
    (``baseline_path`` None: the raw findings)."""
    from goworld_tpu_torch.analysis import rules as rules_mod

    if modules is None:
        modules = parse_package(root)
    active = tuple(rules) if rules is not None else RULE_IDS
    raw: list[Violation] = []
    for rid in active:
        raw.extend(rules_mod.CHECKERS[rid](modules, root))

    baseline = load_baseline(baseline_path) if baseline_path else []
    unsuppressed: list[Violation] = []
    suppressed: list[Violation] = []
    for v in sorted(raw, key=lambda v: (v.path, v.line, v.rule)):
        mod_pragmas = next((m.pragmas for m in modules if m.path == v.path),
                           {})
        if v.rule in mod_pragmas.get(v.line, {}):
            suppressed.append(v)
            continue
        hit = next((s for s in baseline if s.matches(v)), None)
        if hit is not None:
            hit.used += 1
            suppressed.append(v)
        else:
            unsuppressed.append(v)
    stale = [s for s in baseline if not s.used]
    return LintResult(unsuppressed, suppressed, stale, modules)
