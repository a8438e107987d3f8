"""Symbol reachability: dead module-level defs and unused imports.

This is gwlint's janitorial pass (``tools/gwlint.py --dead-code``), NOT a
gating rule: name-based reachability over a dynamic codebase is
conservative in one direction only (a reported symbol really has no
textual reference anywhere), so findings are reviewed and deleted by a
human, not failed by CI.  References are gathered from the package plus
every caller surface that legitimately reaches into it: tests/, tools/,
bench.py, examples/, and the graft entry point.

A module-level def counts as referenced if its bare name appears
anywhere outside its own definition as a Name load, an attribute access,
or inside a string literal (getattr-by-name, entity-class registration
and RPC dispatch all go through strings in this engine).  ``__dunder__``
names, ``main``, and anything exported via ``__all__`` are always kept.
An import is unused if the bound alias has no Load/attribute use in its
module — except in ``__init__.py`` files, where imports ARE the export
surface.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from goworld_tpu_torch.analysis.core import ParsedModule, iter_py_files

#: caller surfaces outside the package whose references keep symbols alive
EXTRA_ROOTS = ("tests", "tools", "examples")
EXTRA_FILES = ("bench.py", "__graft_entry__.py")


@dataclasses.dataclass
class DeadSymbol:
    path: str
    line: int
    name: str
    kind: str  # "function" | "class" | "import"

    def render(self) -> str:
        return f"{self.path}:{self.line}: unreferenced {self.kind} {self.name!r}"


def _string_words(tree: ast.AST) -> set[str]:
    words: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            words.update(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", node.value))
    return words


def _referenced_names(tree: ast.AST) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    return names


def find_dead_code(root: str, modules: list[ParsedModule]
                   ) -> list[DeadSymbol]:
    # one global reference pool: package + caller surfaces
    refs: set[str] = set()
    strings: set[str] = set()
    all_sources: list[tuple[str, ast.AST]] = [
        (m.path, m.tree) for m in modules]
    for sub in EXTRA_ROOTS:
        if os.path.isdir(os.path.join(root, sub)):
            for path in iter_py_files(root, sub):
                try:
                    pm = ParsedModule(root, path)
                except SyntaxError:
                    continue
                all_sources.append((pm.path, pm.tree))
    for fn in EXTRA_FILES:
        p = os.path.join(root, fn)
        if os.path.exists(p):
            try:
                pm = ParsedModule(root, p)
            except SyntaxError:
                continue
            all_sources.append((pm.path, pm.tree))
    # precompute per-source reference/string sets ONCE — recomputing them
    # per candidate symbol is quadratic over the repo (≈100 s vs ≈1 s)
    per_source: dict[str, tuple[set[str], set[str]]] = {
        p: (_referenced_names(tree), _string_words(tree))
        for p, tree in all_sources}
    for names, words in per_source.values():
        refs |= names
        strings |= words

    out: list[DeadSymbol] = []
    for mod in modules:
        exported: set[str] = set()
        for stmt in mod.tree.body:
            if (isinstance(stmt, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in stmt.targets)
                    and isinstance(stmt.value, (ast.List, ast.Tuple))):
                exported.update(
                    e.value for e in stmt.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
        # per-module reference pools, computed once (per-symbol ast.walk
        # sweeps made this pass quadratic over the repo)
        name_counts: dict[str, int] = {}
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Name):
                name_counts[n.id] = name_counts.get(n.id, 0) + 1
        attr_uses = {n.attr for n in ast.walk(mod.tree)
                     if isinstance(n, ast.Attribute)}
        mod_strings = per_source[mod.path][1]
        # dead module-level defs: name referenced nowhere but its def
        for stmt in mod.tree.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                continue
            name = stmt.name
            if (name.startswith("__") or name == "main"
                    or name in exported
                    or (stmt.lineno <= len(mod.lines)
                        and "gwlint: keep" in mod.lines[stmt.lineno - 1])):
                continue
            # the def binds no Name node for itself, so any Name/attr
            # occurrence is a real reference
            referenced_locally = (name_counts.get(name, 0) > 0
                                  or name in attr_uses)
            external = any(
                name in names or name in words
                for p, (names, words) in per_source.items()
                if p != mod.path)
            if not referenced_locally and not external and \
                    name not in strings:
                kind = ("class" if isinstance(stmt, ast.ClassDef)
                        else "function")
                out.append(DeadSymbol(mod.path, stmt.lineno, name, kind))
        # unused imports (skip __init__.py: imports are the API there)
        if mod.path.endswith("__init__.py"):
            continue
        for node in ast.walk(mod.tree):
            names: list[tuple[str, int]] = []
            if isinstance(node, ast.Import):
                for a in node.names:
                    bound = a.asname or a.name.split(".")[0]
                    names.append((bound, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue  # compiler directive, not a binding to use
                for a in node.names:
                    if a.name == "*":
                        continue
                    names.append((a.asname or a.name, node.lineno))
            for bound, line in names:
                if bound.startswith("_"):
                    continue
                if bound in exported:
                    continue
                # a Name load, attribute use, or annotation string use
                kept = line <= len(mod.lines) and \
                    "gwlint: keep" in mod.lines[line - 1]
                if (name_counts.get(bound, 0) == 0
                        and bound not in attr_uses
                        and bound not in mod_strings
                        and not kept):
                    out.append(DeadSymbol(mod.path, line, bound, "import"))
    return out
