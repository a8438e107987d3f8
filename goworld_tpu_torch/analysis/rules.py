"""The seven engine-specific gwlint rules over the port's package.

Each checker takes the parsed package (list[ParsedModule]) plus the repo
root and returns Violations.  All checks are heuristic AST passes tuned to
THIS codebase's idioms; anything they over-report is suppressed in the
package's baseline (``goworld_tpu_torch/analysis/gwlint_baseline.toml``)
with a written justification, so precision bugs cost a review line, never
a silent pass.  The rules:

- **R1 sync hygiene** — whole-program: functions reachable from a dispatch
  (every step program, i.e. every function that calls
  ``sentinel.note_launch``, every engine's ``step_async`` and
  ``BatchAOIService._dispatch``; cross-module call graph, ``self.*``
  methods and constructors resolved) must not call a PyTorch primitive
  that blocks the host on the device stream (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` or ``np.asarray()`` of a device tensor (or of
  a ``HostArray``, which waits for its copy), ``synchronize()``,
  ``nonzero`` / ``unique`` / ``masked_select``, ``repeat_interleave``
  without ``output_size``, ``float()`` / ``int()`` / ``bool()`` of a
  device value, ``.to("cpu")`` and copies across the bus without
  ``non_blocking=True``) or mutate module-level state.  Host data is told
  apart by its binding: a parameter annotated with a non-tensor type, or
  a name bound by a numpy call, a ``pin_memory=True`` allocation or
  ``.numpy()``.  ``chip_smoke.py``'s ``sync_check`` holds the rule
  against the syncs the card reports during real dispatches.
- **R2 hot-path shape** — functions on the tick/collect/route/demux hot
  paths (``@hot_path``-decorated or listed in ``HOT_PATHS``) must not
  contain per-item Python loops over non-constant iterables or
  per-record ``struct.pack`` inside a loop.
- **R3 parse-bounds** — in ``netutil/`` and ``proto/``, unpack/index
  reads of received buffers must be dominated by a ``len()`` guard or an
  enclosing try/except that catches the short-read error.
- **R4 lock discipline** — lock acquisition goes through ``with``; no
  ``time.sleep`` / socket send/recv / blocking queue op lexically inside
  a held-lock region.
- **R5 telemetry hygiene** — metric families register at module scope,
  counters never ``.dec()``, trace spans are context-managed (or
  explicitly recorded) rather than half-entered.
- **R6 config-key drift** — every ini key read in
  ``config/read_config.py`` exists in ``goworld.ini.sample`` and vice
  versa (numbered sections fold into their family; ``start_nodes_N``
  matches the prefix reader).
- **R7 proto conformance** — whole-program wire-schema agreement: every
  pack site (ordered ``append_*`` calls on a locally built Packet sent
  with a ``MsgType.X`` literal) and every handler-side unpack site
  (ordered ``read_*`` calls in ``dispatcher/``, ``gate/``, ``game/``,
  ``rebalance/``, attributed per msgtype via handler tables and
  ``msgtype == MsgType.X`` branches) must match the declared field
  sequence in ``proto/schema.py``; the schema digest must match the
  ``SCHEMA_HISTORY`` pin for the current ``PROTO_VERSION`` — a layout
  edit without a version bump fails here, not in production.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator, Optional

from goworld_tpu_torch.analysis.core import ParsedModule, Violation

# --- shared AST helpers ------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """"a.b.c" for a Name/Attribute chain; None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def module_name(path: str) -> str:
    mod = path[:-3].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def import_map(mod: ParsedModule) -> dict[str, str]:
    """Local alias -> fully qualified target (relative imports resolved)."""
    modname = module_name(mod.path)
    package = modname if mod.path.endswith("__init__.py") else (
        modname.rsplit(".", 1)[0] if "." in modname else "")
    out: dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".") if package else []
                if node.level > 1:
                    parts = parts[: len(parts) - (node.level - 1)]
                base = ".".join(parts + ([node.module] if node.module else []))
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{base}.{a.name}" if base else a.name
    return out


def walk_scoped(tree: ast.AST) -> Iterator[tuple[str, ast.AST]]:
    """Yield (enclosing dotted scope, node) for every node."""

    def visit(node: ast.AST, scope: str) -> Iterator[tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                sub = f"{scope}.{child.name}" if scope else child.name
                yield scope, child
                yield from visit(child, sub)
            else:
                yield scope, child
                yield from visit(child, scope)

    yield from visit(tree, "")


def body_nodes(fn: ast.AST, into_nested: bool = True) -> Iterator[ast.AST]:
    """Every node lexically inside ``fn``'s body (optionally skipping
    nested function/lambda bodies — deferred execution)."""

    def visit(node: ast.AST) -> Iterator[ast.AST]:
        for child in ast.iter_child_nodes(node):
            yield child
            if not into_nested and isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
                continue
            yield from visit(child)

    for stmt in getattr(fn, "body", []):
        yield stmt
        yield from visit(stmt)


# --- R1: sync hygiene --------------------------------------------------------
#
# JAX's R1 guarded functions traced under jax.jit. Eager PyTorch traces
# nothing; the invariant that matters is that a dispatch never blocks the
# host on the device stream, so tick t+1 is queued while tick t's packed
# result is on its way to the host. R1's roots are therefore the step
# programs (every function that counts a launch with
# ``sentinel.note_launch``, the port's counterpart of a SentinelJit-wrapped
# function), every engine's ``step_async`` and the service's dispatch.

#: method names rooted in every class, and qualified roots by path
_ROOT_METHODS = {"step_async"}
_ROOTS = {
    "goworld_tpu_torch/entity/aoi/batched.py": {"BatchAOIService._dispatch"},
}
#: calls that block the host until the stream has computed their input
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
#: calls whose output is sized by device data (the host waits to read it)
_SIZED_BY_DATA = {"nonzero", "unique", "masked_select"}
_SCALAR_CASTS = {"float", "int", "bool"}
_NUMPY_HOST_FUNCS = {"asarray", "array"}
_DTYPE_NAMES = {"bool", "uint8", "int8", "int16", "int32", "int64", "float16",
                "bfloat16", "float32", "float64", "long", "int", "float",
                "half", "double"}


class _ProgramIndex:
    def __init__(self, modules: list[ParsedModule]) -> None:
        self.modules = {module_name(m.path): m for m in modules}
        # modname -> {qualname: def node}
        self.defs: dict[str, dict[str, ast.AST]] = {}
        self.classes: dict[str, set[str]] = {}
        self.imports: dict[str, dict[str, str]] = {}
        self.np_aliases: dict[str, set[str]] = {}
        for name, m in self.modules.items():
            defs: dict[str, ast.AST] = {}
            classes: set[str] = set()
            for scope, node in walk_scoped(m.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{scope}.{node.name}" if scope else node.name
                    defs[qual] = node
                elif isinstance(node, ast.ClassDef):
                    qual = f"{scope}.{node.name}" if scope else node.name
                    classes.add(qual)
            self.defs[name] = defs
            self.classes[name] = classes
            imp = import_map(m)
            self.imports[name] = imp
            self.np_aliases[name] = {
                a for a, tgt in imp.items()
                if tgt == "numpy" or tgt.startswith("numpy.")}

    def _def_or_ctor(self, modname: str,
                     qual: str) -> Optional[tuple[str, str]]:
        """A function, or a class's ``__init__`` (calling a class runs
        its constructor)."""
        if qual in self.defs.get(modname, {}):
            return (modname, qual)
        if f"{qual}.__init__" in self.defs.get(modname, {}):
            return (modname, f"{qual}.__init__")
        return None

    def resolve(self, modname: str, scope: str,
                ref: str) -> Optional[tuple[str, str]]:
        """Resolve a dotted reference at ``scope`` in ``modname`` to a
        package function: (modname, qualname), or None."""
        parts = ref.split(".")
        if parts[0] in ("self", "cls") and len(parts) == 2:
            # method of the nearest enclosing class in the scope chain
            sp = scope.split(".")
            for i in range(len(sp), 0, -1):
                cand = ".".join(sp[:i])
                if cand in self.classes.get(modname, ()):
                    qual = f"{cand}.{parts[1]}"
                    if qual in self.defs.get(modname, {}):
                        return (modname, qual)
            return None
        if len(parts) == 1:
            # lexical scope chain, innermost first
            sp = scope.split(".") if scope else []
            for i in range(len(sp), -1, -1):
                cand = ".".join(sp[:i] + [ref]) if i else ref
                hit = self._def_or_ctor(modname, cand)
                if hit:
                    return hit
            tgt = self.imports.get(modname, {}).get(ref)
            if tgt and tgt.startswith("goworld_tpu_torch") and "." in tgt:
                tmod, tname = tgt.rsplit(".", 1)
                return self._def_or_ctor(tmod, tname)
            return None
        # alias.func: alias must name a package module
        tgt = self.imports.get(modname, {}).get(parts[0])
        if tgt and tgt.startswith("goworld_tpu_torch") and len(parts) == 2:
            return self._def_or_ctor(tgt, parts[1])
        return None


def _sync_roots(index: _ProgramIndex) -> set[tuple[str, str]]:
    roots: set[tuple[str, str]] = set()
    for modname, defs in index.defs.items():
        listed = _ROOTS.get(index.modules[modname].path, set())
        for qual, fn in defs.items():
            if qual in listed or qual.split(".")[-1] in _ROOT_METHODS:
                roots.add((modname, qual))
                continue
            for node in body_nodes(fn, into_nested=False):
                if isinstance(node, ast.Call) and (
                        dotted(node.func) or "").endswith("note_launch"):
                    roots.add((modname, qual))
                    break
    return roots


def _reachable(index: _ProgramIndex,
               roots: set[tuple[str, str]]) -> set[tuple[str, str]]:
    seen = set(roots)
    frontier = list(roots)
    while frontier:
        modname, qual = frontier.pop()
        fn = index.defs[modname].get(qual)
        if fn is None:
            continue
        for node in body_nodes(fn):
            ref = None
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                ref = node.id
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                ref = dotted(node)
            if not ref:
                continue
            hit = index.resolve(modname, qual, ref)
            if hit and hit not in seen:
                seen.add(hit)
                frontier.append(hit)
    return seen


def _module_mutables(mod: ParsedModule) -> set[str]:
    """Module-level names bound to obviously-mutable containers."""
    out: set[str] = set()
    for stmt in mod.tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name) and stmt.value is not None:
            targets = [stmt.target]
            value = stmt.value
        else:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp, ast.SetComp))
        if isinstance(value, ast.Call):
            d = dotted(value.func)
            if d and d.split(".")[-1] in ("list", "dict", "set",
                                          "defaultdict", "deque",
                                          "OrderedDict"):
                mutable = True
        if mutable:
            out.update(t.id for t in targets)
    return out


_MUTATOR_ATTRS = {"append", "extend", "update", "setdefault", "add",
                  "pop", "popitem", "insert", "remove", "clear"}


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    return next((k.value for k in call.keywords if k.arg == name), None)


def _is_true(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_cpu(node: Optional[ast.expr]) -> bool:
    """A device literal naming the host: ``"cpu"`` or
    ``torch.device("cpu")``."""
    if isinstance(node, ast.Call) and (dotted(node.func) or "").endswith(
            "device") and node.args:
        node = node.args[0]
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _is_dtype(node: ast.expr) -> bool:
    """``torch.int32``-style literals and ``x.dtype`` reads."""
    if isinstance(node, ast.Attribute) and node.attr == "dtype":
        return True
    parts = (dotted(node) or "").split(".")
    return len(parts) == 2 and parts[0] == "torch" and \
        parts[1] in _DTYPE_NAMES


def _host_names(fn: ast.AST, np_alias: set[str]) -> set[str]:
    """Names that hold host data in ``fn``: parameters annotated with a
    type that is not a tensor, and names bound by a numpy call, a pinned
    allocation (``pin_memory=True``), ``.numpy()``, or an expression over
    host names only. A scalar cast or ``.numpy()`` of host data does not
    sync; the same call on a device tensor does."""
    host = {a.arg for a in _all_args(fn)
            if a.annotation is not None
            and "Tensor" not in ast.unparse(a.annotation)}
    changed = True
    while changed:
        changed = False
        for node in body_nodes(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if name not in host and _is_host(node.value, host, np_alias):
                host.add(name)
                changed = True
    return host


def _is_host(expr: ast.AST, host: set[str], np_alias: set[str]) -> bool:
    if isinstance(expr, ast.Call):
        d = dotted(expr.func) or ""
        if d.split(".")[0] in np_alias or _is_true(_kw(expr, "pin_memory")):
            return True
        if isinstance(expr.func, ast.Attribute) and \
                expr.func.attr == "numpy":
            return True
        if d in ("len", "np.shape"):
            return True
    return names_in(expr) - np_alias - {"len", "min", "max", "abs"} <= host


def _sync_call(node: ast.Call, host: set[str],
               np_alias: set[str]) -> Optional[str]:
    """Why ``node`` blocks the host on the device stream, or None."""
    d = dotted(node.func) or ""
    if d in _SCALAR_CASTS:
        if len(node.args) == 1 and \
                not _is_host(node.args[0], host, np_alias):
            return f"{d}(x) of a device tensor reads it on the host"
        return None
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    arg = node.args[0] if node.args else None
    if attr == "synchronize":
        return f"{d or attr}() waits for the device"
    if attr in _NUMPY_HOST_FUNCS and d.split(".")[0] in np_alias:
        if arg is not None and not _is_host(arg, host, np_alias):
            return (f"{d}() of a device tensor or a HostArray waits for its "
                    f"copy to the host")
        return None
    if d in ("torch.tensor", "torch.as_tensor"):
        dev = _kw(node, "device")
        if dev is not None and not _is_cpu(dev):
            return (f"{d}(..., device=) copies host data to the device and "
                    f"waits")
        return None
    on_host = _is_host(node.func.value, host, np_alias)
    if attr in ("to", "copy_", "cuda"):
        return _blocking_copy(node, on_host, host, np_alias)
    if on_host:
        return None
    if attr in _HOST_READS:
        return f".{attr}() copies a device tensor to the host and waits"
    if attr in _SIZED_BY_DATA:
        return f"{d or attr}() sizes its output from device data and waits"
    if attr == "repeat_interleave" and _kw(node, "output_size") is None:
        return ("repeat_interleave without output_size sizes its output "
                "from device data and waits")
    return None


def _blocking_copy(node: ast.Call, on_host: bool, host: set[str],
                   np_alias: set[str]) -> Optional[str]:
    """Why a ``.to`` / ``.copy_`` / ``.cuda`` call waits for its copy
    across the bus, or None. A copy without ``non_blocking=True`` waits
    whichever side its receiver is on (the card reports blocking uploads
    from pinned and pageable memory alike); a dtype cast, a host tensor's
    ``.to('cpu')`` and a copy between two host buffers stay on the host."""
    attr = node.func.attr
    arg = node.args[0] if node.args else None
    if _is_true(_kw(node, "non_blocking")):
        return None
    if attr == "copy_" and on_host and arg is not None and \
            _is_host(arg, host, np_alias):
        return None
    if attr in ("copy_", "cuda"):
        return (f".{attr}() without non_blocking=True waits when it crosses "
                f"the bus")
    target = arg if arg is not None else _kw(node, "device")
    if target is None or _is_dtype(target) or _kw(node, "dtype") is not None:
        return None
    if _is_cpu(target):
        return None if on_host else ".to('cpu') copies to the host and waits"
    return (".to(device) without non_blocking=True copies across the bus "
            "and waits")


def check_r1(modules: list[ParsedModule], root: str) -> list[Violation]:
    index = _ProgramIndex(modules)
    reach = _reachable(index, _sync_roots(index))
    out: list[Violation] = []
    for modname, qual in sorted(reach):
        mod = index.modules[modname]
        np_alias = index.np_aliases[modname]
        mutables = _module_mutables(mod)
        fn = index.defs[modname][qual]
        host = _host_names(fn, np_alias)
        for node in body_nodes(fn):
            if isinstance(node, ast.Global):
                out.append(mod.violation(
                    "R1", node,
                    "dispatch-reachable function rebinds module state "
                    "via `global`"))
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(
                    node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        base = dotted(t.value)
                        if base in mutables:
                            out.append(mod.violation(
                                "R1", node,
                                f"mutates module-level container "
                                f"{base!r} in a dispatch"))
            if not isinstance(node, ast.Call):
                continue
            why = _sync_call(node, host, np_alias)
            if why:
                out.append(mod.violation(
                    "R1", node,
                    f"{why} inside a dispatch-reachable function"))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _MUTATOR_ATTRS):
                base = dotted(node.func.value)
                if base in mutables:
                    out.append(mod.violation(
                        "R1", node,
                        f"mutates module-level container {base!r} in a "
                        f"dispatch"))
    return out


# --- R2: hot-path shape ------------------------------------------------------

# path -> function names (bare, matched against the tail of the dotted
# symbol).  These are the per-tick collect/route/demux/fan-out paths the
# fanout and pinned floors measure.
HOT_PATHS: dict[str, set[str]] = {
    "goworld_tpu_torch/entity/slabs.py": {
        "collect_sync_selection", "pack_sync", "collect_sync",
        "run_tick_batches", "set_position_yaw",
        # Adaptive per-client sync: the tiered collect runs
        # every position-sync collection — selection, quantization,
        # baseline advance and wire pack must stay vectorized.
        "_collect_sync_tiered", "_emit_mask", "_pack_rows",
        "retier_host",
    },
    "goworld_tpu_torch/dispatcher/service.py": {
        "_handle_sync_position_yaw_from_client", "_send_pending_syncs",
        "_flush_pending_sync", "_route_to_gate",
    },
    "goworld_tpu_torch/gate/service.py": {
        "_handle_sync_on_clients", "_handle_sync_delta_on_clients",
        "_flush_pending_syncs",
    },
    "goworld_tpu_torch/ops/neighbor.py": {
        # The step program and the passes that ride it run every tick:
        # loop-free torch. The per-program unroll lives in
        # _apply_fused_logic, outside the guarded set by design
        # (O(entity classes), not O(entities)); its callers are guarded.
        "_step_packed_tiered", "_step_pallas", "_step_packed_jnp",
        "_bins", "_build_table", "_fast_guard", "_scatter_feats",
        "_drain_bits", "_tier_pass", "_edge_verdicts",
    },
    # The event kernel's wrappers launch on every tick: argument checks
    # and one foreign call, no per-cell Python.
    "goworld_tpu_torch/ops/event_kernel.py": {"event_mask", "event_drain"},
    "goworld_tpu_torch/parallel/spatial.py": {
        # The strip program's bodies, the strip-local tables and drain
        # and the seam-free guard run every strip tick. Their loops over
        # the strips are O(devices), like the ring exchange in
        # _exchange_halo, outside the guarded set (baselined where they
        # sit in a guarded body).
        "_spatial_step_pallas_impl", "_spatial_step_pallas_fused_impl",
        "_spatial_step_fused_impl", "_spatial_step_strips",
        "_spatial_drain_bits", "_build_table_strip", "_fast_guard_strip",
        # The slot/own plane scatter feeding the drain form's pair
        # emission runs every strip tick.
        "_scatter_slotown",
    },
    # Fused interest-edge delivery: the decode split and the
    # device edge-snapshot build run every delivery tick — vectorized
    # numpy only; the thin guarded per-row loop lives in _apply_edge_rows,
    # outside the guarded set by design (it is the contractual per-entity
    # interest bookkeeping, already minimal).
    "goworld_tpu_torch/entity/aoi/batched.py": {
        "_deliver_fused", "_build_device_edges",
    },
    # The entity-sharded tier's programs: the fused all-gather step and
    # the slab program's per-shard body, slab cut and drain run every
    # tick (the loop over shards lives in _shard_steps, O(devices),
    # outside the guarded set).
    "goworld_tpu_torch/parallel/mesh.py": {
        "_sharded_step_fused", "_fused_rows", "_sharded_step_kernel",
        "_kernel_shard", "_slab", "_sharded_drain_bits",
    },
    # Scenario matrix: each scenario's per-tick world update
    # runs every scenario tick and must stay vectorized numpy — the
    # bounded per-op service loop lives in service_heavy._issue_ops,
    # outside the guarded set by design (64 ops/tick by config, not
    # O(entities)).
    "goworld_tpu_torch/scenarios/battle_royale.py": {"tick"},
    "goworld_tpu_torch/scenarios/hotspot.py": {"tick"},
    "goworld_tpu_torch/scenarios/service_heavy.py": {"tick"},
    # Whole-space handoff: the snapshot/restore bodies run with
    # every member's dispatcher stream PARKED — wall-clock here is client
    # stall, so per-member work must stay slab/struct ops (the per-member
    # loops that remain are baselined with their boundedness reasons).
    "goworld_tpu_torch/entity/entity_manager.py": {
        "pack_space", "restore_space_bundle",
        # Columnar batch persistence: the per-column gather
        # core — loop-free; the per-entity cache stitch stays in
        # primed_column_snapshot outside the guarded set (dict stores).
        "_gather_column",
    },
    "goworld_tpu_torch/rebalance/migrator.py": {
        "handle_space_command", "_pack_and_send", "on_space_data",
        "_tick_spaces",
    },
    # Black-box history ring: the frame encode runs on every
    # history cadence in every process — header pack + slice assign into
    # a grow-only buffer, no loops, no per-frame object churn (the
    # payload walk lives in _collect, off the guarded set: it is the
    # snapshot-cadence collector, not the encode).
    "goworld_tpu_torch/telemetry/history.py": {"_encode_frame"},
}


def _is_const_bounded(it: ast.AST) -> bool:
    if isinstance(it, (ast.Tuple, ast.List, ast.Set, ast.Dict, ast.Constant)):
        return True
    if isinstance(it, ast.Call):
        d = dotted(it.func)
        if d in ("range", "enumerate", "reversed", "zip") and all(
                _is_const_bounded(a) or isinstance(a, ast.Constant)
                for a in it.args):
            return True
    return False


def _hot_functions(mod: ParsedModule) -> list[tuple[str, ast.AST]]:
    listed = HOT_PATHS.get(mod.path, set())
    out = []
    for scope, node in walk_scoped(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        qual = f"{scope}.{node.name}" if scope else node.name
        decorated = any(
            (dotted(dec) or "").split(".")[-1] == "hot_path"
            for dec in node.decorator_list)
        if decorated or node.name in listed:
            out.append((qual, node))
    return out


def check_r2(modules: list[ParsedModule], root: str) -> list[Violation]:
    out: list[Violation] = []
    for mod in modules:
        for qual, fn in _hot_functions(mod):
            loop_spans: list[tuple[int, int]] = []
            for node in body_nodes(fn):
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    loop_spans.append(
                        (node.lineno, node.end_lineno or node.lineno))
                    if not _is_const_bounded(node.iter):
                        src = ast.unparse(node.iter)
                        out.append(mod.violation(
                            "R2", node,
                            f"per-item Python loop over {src!r} on a "
                            f"hot path — vectorize or prove the iterable "
                            f"O(gates), not O(entities)"))
                elif isinstance(node, ast.While):
                    loop_spans.append(
                        (node.lineno, node.end_lineno or node.lineno))
                    out.append(mod.violation(
                        "R2", node,
                        "while-loop on a hot path — prove bounded or "
                        "vectorize"))
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    for gen in node.generators:
                        if not _is_const_bounded(gen.iter):
                            src = ast.unparse(gen.iter)
                            out.append(mod.violation(
                                "R2", node,
                                f"per-item comprehension over {src!r} on "
                                f"a hot path"))
            for node in body_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if not d or d.split(".")[-1] not in ("pack", "pack_into"):
                    continue
                parts = d.split(".")
                packish = (parts[0] == "struct"
                           or "struct" in parts[-2].lower()
                           if len(parts) > 1 else False)
                if not packish:
                    continue
                in_loop = any(lo < node.lineno <= hi for lo, hi in loop_spans)
                if in_loop:
                    out.append(mod.violation(
                        "R2", node,
                        f"per-record {d} inside a loop on a hot path — "
                        f"build columns and pack once"))
    return out


# --- R3: parse bounds --------------------------------------------------------

_BUF_PARAM_NAMES = {
    "data", "buf", "buff", "buffer", "payload", "raw", "b", "msg", "frame",
    "chunk", "body", "blob", "segment", "seg", "datagram", "wire", "packed",
}
_RECV_FUNCS = {"recv", "recvfrom", "recv_exact", "read", "read_exact",
               "readexactly"}
_SHORT_READ_ERRORS = {"error", "struct", "IndexError", "ValueError",
                      "Exception", "BaseException", "KeyError"}


def _buffer_names(fn: ast.AST) -> set[str]:
    bufs = {a.arg for a in _all_args(fn) if a.arg in _BUF_PARAM_NAMES}
    # propagate through simple assignments (memoryview(data), data[4:], recv)
    changed = True
    while changed:
        changed = False
        for node in body_nodes(fn):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name) or tgt.id in bufs:
                continue
            src_names = names_in(node.value)
            from_recv = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _RECV_FUNCS
                for n in ast.walk(node.value))
            if (src_names & bufs) or from_recv:
                bufs.add(tgt.id)
                changed = True
    return bufs


def _all_args(fn: ast.AST) -> list[ast.arg]:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


_GUARD_FN_RE = re.compile(r"(need|check|require|ensure|guard|bounds)",
                          re.IGNORECASE)


def _guard_lines(fn: ast.AST, bufs: set[str]) -> list[int]:
    """Lines where a len() of a buffer name occurs, or where the buffer
    is passed to a bounds-guard helper (``_need(data, off, 8)`` — the
    conventional names are matched by _GUARD_FN_RE)."""
    out = []
    for node in body_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Name) and node.func.id == "len"
                and node.args and (names_in(node.args[0]) & bufs)):
            out.append(node.lineno)
            continue
        d = dotted(node.func)
        if (d and _GUARD_FN_RE.search(d.split(".")[-1])
                and any(names_in(a) & bufs for a in node.args)):
            out.append(node.lineno)
    return out


def _try_spans(fn: ast.AST) -> list[tuple[int, int]]:
    spans = []
    for node in body_nodes(fn):
        if not isinstance(node, ast.Try):
            continue
        catches = False
        for h in node.handlers:
            if h.type is None:
                catches = True
            else:
                for t in ([h.type.elts] if isinstance(h.type, ast.Tuple)
                          else [[h.type]]):
                    for e in t:
                        d = dotted(e) or ""
                        if d.split(".")[0] in _SHORT_READ_ERRORS or \
                                d.split(".")[-1] in _SHORT_READ_ERRORS:
                            catches = True
        if catches and node.body:
            lo = node.body[0].lineno
            hi = max(s.end_lineno or s.lineno for s in node.body)
            spans.append((lo, hi))
    return spans


def check_r3(modules: list[ParsedModule], root: str) -> list[Violation]:
    out: list[Violation] = []
    for mod in modules:
        if not (mod.path.startswith("goworld_tpu_torch/netutil/")
                or mod.path.startswith("goworld_tpu_torch/proto/")):
            continue
        for scope, node in walk_scoped(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            bufs = _buffer_names(node)
            if not bufs:
                continue
            guards = _guard_lines(node, bufs)
            tries = _try_spans(node)

            def covered(line: int) -> bool:
                # <= : `if len(parts) == 3 and parts[0] ...` guards
                # same-line reads via short-circuit evaluation
                return (any(g <= line for g in guards)
                        or any(lo <= line <= hi for lo, hi in tries))

            for sub in body_nodes(node):
                if isinstance(sub, ast.Call):
                    d = dotted(sub.func)
                    risky = None
                    if d and d.split(".")[-1] in ("unpack", "unpack_from"):
                        if any(names_in(a) & bufs for a in sub.args):
                            risky = f"{d}()"
                    elif d == "int.from_bytes" and sub.args and (
                            names_in(sub.args[0]) & bufs):
                        risky = "int.from_bytes()"
                    if risky and not covered(sub.lineno):
                        out.append(mod.violation(
                            "R3", sub,
                            f"{risky} reads a received buffer "
                            f"({sorted(names_in(sub) & bufs)}) with no "
                            f"dominating len() guard or short-read "
                            f"try/except — a truncated frame crashes the "
                            f"connection loop"))
                elif (isinstance(sub, ast.Subscript)
                      and isinstance(sub.ctx, ast.Load)
                      and isinstance(sub.value, ast.Name)
                      and sub.value.id in bufs
                      and not isinstance(sub.slice, ast.Slice)):
                    if not covered(sub.lineno):
                        out.append(mod.violation(
                            "R3", sub,
                            f"single-index read of received buffer "
                            f"{sub.value.id!r} with no dominating len() "
                            f"guard — IndexError on a truncated frame"))
    return out


# --- R4: lock discipline -----------------------------------------------------

_BLOCKING_SOCKET_ATTRS = {"recv", "recvfrom", "sendall", "sendto",
                          "accept", "connect", "makefile"}
_LOCK_CTORS = {"Lock", "RLock"}


def _locky(name: Optional[str]) -> bool:
    if not name:
        return False
    tail = name.split(".")[-1].lower()
    return "lock" in tail or "mutex" in tail or tail in ("lk", "_lk", "mu")


def _known_locks(mod: ParsedModule) -> set[str]:
    """Attribute/name tails assigned a threading.Lock()/RLock()."""
    out: set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        d = dotted(node.value.func) or ""
        if d.split(".")[-1] not in _LOCK_CTORS:
            continue
        for t in node.targets:
            tail = (dotted(t) or "").split(".")[-1]
            if tail:
                out.add(tail)
    return out


def check_r4(modules: list[ParsedModule], root: str) -> list[Violation]:
    out: list[Violation] = []
    for mod in modules:
        known = _known_locks(mod)

        def lockish(expr: ast.AST) -> bool:
            d = dotted(expr)
            return bool(d) and (_locky(d) or d.split(".")[-1] in known)

        for scope, node in walk_scoped(mod.tree):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute):
                if node.func.attr in ("acquire", "release") and lockish(
                        node.func.value):
                    out.append(mod.violation(
                        "R4", node,
                        f"bare .{node.func.attr}() on "
                        f"{dotted(node.func.value)!r} — use `with` so the "
                        f"release survives exceptions (and lockgraph can "
                        f"see the critical section)"))
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_items = [i for i in node.items
                          if lockish(i.context_expr)]
            if not lock_items:
                continue
            held = {dotted(i.context_expr) for i in lock_items}
            for sub in body_nodes(node, into_nested=False):
                if not isinstance(sub, ast.Call):
                    continue
                d = dotted(sub.func)
                if not d:
                    continue
                parts = d.split(".")
                attr = parts[-1]
                recv = ".".join(parts[:-1])
                msg = None
                if d == "time.sleep":
                    msg = "time.sleep under a held lock"
                elif attr in _BLOCKING_SOCKET_ATTRS and len(parts) > 1:
                    msg = f"blocking socket call .{attr}() under a held lock"
                elif attr in ("get", "put") and "queue" in recv.lower():
                    blockless = any(
                        kw.arg == "block"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False
                        for kw in sub.keywords) or (
                        sub.args and isinstance(sub.args[0], ast.Constant)
                        and sub.args[0].value is False)
                    if not blockless:
                        msg = (f"blocking queue .{attr}() under a held "
                               f"lock")
                elif attr in ("wait", "wait_connected") and \
                        recv not in held and _locky(recv) is False:
                    if attr == "wait_connected" or (
                            recv and ("event" in recv.lower()
                                      or "cond" in recv.lower()
                                      or "future" in recv.lower())):
                        msg = f".{attr}() under a held lock"
                elif attr == "join" and recv and (
                        "thread" in recv.lower() or "worker" in recv.lower()
                        or "proc" in recv.lower()):
                    msg = "thread join under a held lock"
                if msg:
                    out.append(mod.violation(
                        "R4", sub,
                        f"{msg} ({sorted(held)}) — every other thread "
                        f"touching this lock stalls for the full wait"))
    return out


# --- R5: telemetry hygiene ---------------------------------------------------


def check_r5(modules: list[ParsedModule], root: str) -> list[Violation]:
    out: list[Violation] = []
    for mod in modules:
        counters: set[str] = set()
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, ast.Call):
                d = dotted(stmt.value.func) or ""
                if d.endswith("REGISTRY.counter"):
                    counters.update(
                        t.id for t in stmt.targets
                        if isinstance(t, ast.Name))
        for scope, node in walk_scoped(mod.tree):
            if isinstance(node, ast.Call):
                d = dotted(node.func) or ""
                parts = d.split(".")
                # registration must happen at module scope
                if (len(parts) >= 2 and parts[-2] == "REGISTRY"
                        and parts[-1] in ("counter", "gauge", "histogram")
                        and scope):
                    out.append(mod.violation(
                        "R5", node,
                        f"metric family {parts[-1]} registered inside "
                        f"{scope!r} — register once at module scope so "
                        f"re-construction can't fork the family"))
                # counters never go down
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "dec"):
                    chain = d or ""
                    head = chain.split(".")[0]
                    if head in counters or ".labels." in f".{chain}.":
                        if head in counters:
                            out.append(mod.violation(
                                "R5", node,
                                f"counter {head!r} .dec()'d — counters "
                                f"are monotonic; use a gauge"))
        # span scopes must be context-managed or explicitly recorded
        for scope, fn in walk_scoped(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            has_record = any(
                isinstance(n, ast.Call)
                and (dotted(n.func) or "").endswith("record_span")
                for n in body_nodes(fn))
            with_subjects: set[str] = set()
            for n in body_nodes(fn):
                if isinstance(n, (ast.With, ast.AsyncWith)):
                    for item in n.items:
                        d = dotted(item.context_expr)
                        if d:
                            with_subjects.add(d)
            enters = exits = 0
            for n in body_nodes(fn):
                if isinstance(n, ast.Call) and isinstance(
                        n.func, ast.Attribute):
                    if n.func.attr == "__enter__":
                        enters += 1
                    elif n.func.attr == "__exit__":
                        exits += 1
                if not isinstance(n, ast.Assign):
                    continue
                if not isinstance(n.value, ast.Call):
                    continue
                d = dotted(n.value.func) or ""
                if d.split(".")[-1] not in ("root_scope", "child_scope",
                                            "SpanScope"):
                    continue
                tgt = n.targets[0]
                tname = dotted(tgt)
                returned = tname and any(
                    isinstance(r, ast.Return) and r.value is not None
                    and tname in names_in(r.value)
                    for r in body_nodes(fn))
                if tname and (tname in with_subjects or has_record
                              or returned):
                    continue
                # scope value used directly in `with` on a later line?
                out.append(mod.violation(
                    "R5", n,
                    f"trace scope assigned to {tname!r} but never "
                    f"entered via `with` nor explicitly record_span'd — "
                    f"a half-opened span never reaches the ring"))
            if enters != exits:
                out.append(mod.violation(
                    "R5", fn,
                    f"unbalanced manual span __enter__/__exit__ "
                    f"({enters} vs {exits}) in one function"))
    return out


# --- R6: config-key drift ----------------------------------------------------

_SECTION_RE = re.compile(r"^\[([A-Za-z_][A-Za-z0-9_]*)\]")
_INI_KEY_RE = re.compile(r"^;?\s*([a-z_][a-z0-9_]*)\s*=")
_GETTERS = {"get", "getint", "getfloat", "getboolean"}


def _family(section: str) -> str:
    base = re.sub(r"\d+$", "", section)
    if base.endswith("_common"):
        base = base[: -len("_common")]
    return base


def _norm_key(key: str) -> str:
    return re.sub(r"^start_nodes_.+$", "start_nodes_N", key)


def _sample_keys(root: str) -> tuple[dict[str, set[str]],
                                     dict[tuple[str, str], int]]:
    fams: dict[str, set[str]] = {}
    lines: dict[tuple[str, str], int] = {}
    section = ""
    path = os.path.join(root, "goworld.ini.sample")
    with open(path, encoding="utf-8") as f:
        for ln, raw in enumerate(f, 1):
            line = raw.rstrip("\n")
            m = _SECTION_RE.match(line.strip())
            if m:
                section = m.group(1)
                continue
            if line.startswith(";"):
                # a commented-out KEY is documented at column 0
                # ("; delivery = pipelined"); indented ';' lines are
                # wrapped prose of an inline comment, never keys
                inner = line[1:].lstrip()
                if inner.startswith(";") or inner.startswith("-"):
                    continue  # double-comment / separator line
                line = inner
            elif line.lstrip().startswith((";", "#")):
                continue
            else:
                line = line.lstrip()
            m2 = _INI_KEY_RE.match(line)
            if m2 and section:
                key = _norm_key(m2.group(1))
                fam = _family(section)
                fams.setdefault(fam, set()).add(key)
                lines.setdefault((fam, key), ln)
    return fams, lines


def _code_keys(mod: ParsedModule) -> dict[str, dict[str, int]]:
    """family -> {key: first line} read in read_config.py, attributed to
    the most recent section-selecting event (linear file structure)."""
    events: list[tuple[int, str]] = []  # (line, family)
    reads: list[tuple[int, str, Optional[str]]] = []  # (line, key, inline fam)
    has_start_nodes_reader = "start_nodes_" in mod.source

    def const_str(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            # f"dispatcher{i}" -> leading constant prefix names the family
            if node.values and isinstance(node.values[0], ast.Constant):
                return str(node.values[0].value)
        return None

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (node.func.id if isinstance(node.func, ast.Name)
                      else "")
            if attr == "has_section" and node.args:
                s = const_str(node.args[0])
                if s:
                    events.append((node.lineno, _family(s)))
            elif attr == "merged" and node.args:
                s = const_str(node.args[0])
                if s:
                    events.append((node.lineno, _family(s)))
            elif attr in _GETTERS and node.args:
                key = const_str(node.args[0])
                if key is None:
                    continue
                inline_fam = None
                recv = node.func.value if isinstance(
                    node.func, ast.Attribute) else None
                if isinstance(recv, ast.Subscript):
                    s = const_str(recv.slice)
                    if s:
                        inline_fam = _family(s)
                reads.append((node.lineno, _norm_key(key), inline_fam))
        elif isinstance(node, ast.Subscript):
            # cp["storage"] as a section-selecting event
            base = dotted(node.value)
            if base == "cp":
                s = const_str(node.slice)
                if s:
                    events.append((node.lineno, _family(s)))

    events.sort()
    out: dict[str, dict[str, int]] = {}
    for line, key, inline_fam in sorted(reads):
        fam = inline_fam
        if fam is None:
            prior = [f for l, f in events if l <= line]
            fam = prior[-1] if prior else ""
        if fam:
            out.setdefault(fam, {}).setdefault(key, line)
    if has_start_nodes_reader:
        for fam in ("storage", "kvdb"):
            out.setdefault(fam, {}).setdefault("start_nodes_N", 1)
    return out


def check_r6(modules: list[ParsedModule], root: str) -> list[Violation]:
    mod = next((m for m in modules
                if m.path == "goworld_tpu_torch/config/read_config.py"), None)
    if mod is None:
        return []
    sample_path = os.path.join(root, "goworld.ini.sample")
    if not os.path.exists(sample_path):
        return []
    sample, sample_lines = _sample_keys(root)
    code = _code_keys(mod)
    out: list[Violation] = []
    for fam, keys in sorted(code.items()):
        for key, line in sorted(keys.items()):
            if key not in sample.get(fam, set()):
                out.append(mod.violation(
                    "R6", line,
                    f"config key [{fam}] {key} is read here but not "
                    f"documented in goworld.ini.sample — operators can't "
                    f"discover it"))
    for fam, keys in sorted(sample.items()):
        for key in sorted(keys):
            if key not in code.get(fam, {}):
                ln = sample_lines.get((fam, key), 1)
                out.append(Violation(
                    "R6", "goworld.ini.sample", ln, f"[{fam}]",
                    f"key {key} documented in goworld.ini.sample is never "
                    f"read by config/read_config.py — drift or typo"))
    return out


# --- R7: proto conformance ---------------------------------------------------
#
# The schema table (proto/schema.py) is re-read from the AST of the tree
# being linted — never imported — so fixture trees lint exactly like the
# real one.  Only the canonical digest FORMAT comes from the engine
# (schema.digest_of), keeping the runtime digest and the lint digest
# structurally identical by construction.

_SCHEMA_PATH = "goworld_tpu_torch/proto/schema.py"
_MSGTYPES_PATH = "goworld_tpu_torch/proto/msgtypes.py"
#: where handler-side reads are attributed and checked
_R7_UNPACK_PREFIXES = ("goworld_tpu_torch/dispatcher/",
                       "goworld_tpu_torch/gate/", "goworld_tpu_torch/game/",
                       "goworld_tpu_torch/rebalance/")
#: pseudo-msgtype for ``is_gate_redirect(msgtype)`` branches: reads must
#: stay within the [u16 gateid][cid clientid] routing prefix
_REDIRECT_ANY = "<redirect-range>"


class _SchemaEntry:
    __slots__ = ("name", "value", "kinds", "raw", "gate_appended", "line")

    def __init__(self, name: str, value: int, kinds: tuple[str, ...],
                 raw: Optional[str], gate_appended: int, line: int) -> None:
        self.name = name
        self.value = value
        self.kinds = kinds
        self.raw = raw
        self.gate_appended = gate_appended
        self.line = line


class _SchemaTable:
    def __init__(self) -> None:
        self.version: Optional[int] = None
        self.trailer: int = 17
        self.history: dict[int, str] = {}
        self.history_line = 1
        self.types: dict[str, int] = {}  # MsgType member name -> value
        self.entries: dict[str, _SchemaEntry] = {}
        self.redirect_min = 1001
        self.redirect_max = 1499


def _const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


def _field_tuple(node: ast.AST) -> Optional[tuple[str, str]]:
    if (isinstance(node, ast.Tuple) and len(node.elts) == 2
            and all(isinstance(e, ast.Constant)
                    and isinstance(e.value, str) for e in node.elts)):
        return (node.elts[0].value, node.elts[1].value)
    return None


def _msgtype_name(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "MsgType"):
        return node.attr
    return None


def _parse_schema_table(modules: list[ParsedModule]
                        ) -> Optional[tuple[_SchemaTable, ParsedModule]]:
    """Extract the schema table + version constants from the linted tree's
    own proto/schema.py and proto/msgtypes.py ASTs.  Returns None when the
    tree has no schema module (fixture trees exercising other rules)."""
    schema_mod = next((m for m in modules if m.path == _SCHEMA_PATH), None)
    types_mod = next((m for m in modules if m.path == _MSGTYPES_PATH), None)
    if schema_mod is None or types_mod is None:
        return None
    table = _SchemaTable()

    for stmt in types_mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            name, val = stmt.targets[0].id, _const_int(stmt.value)
            if val is None:
                continue
            if name == "PROTO_VERSION":
                table.version = val
            elif name == "REDIRECT_MIN":
                table.redirect_min = val
            elif name == "REDIRECT_MAX":
                table.redirect_max = val
        elif isinstance(stmt, ast.ClassDef) and stmt.name == "MsgType":
            for sub in stmt.body:
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name):
                    val = _const_int(sub.value)
                    if val is not None:
                        table.types[sub.targets[0].id] = val

    prefix: tuple[tuple[str, str], ...] = ()
    for stmt in schema_mod.tree.body:
        targets: list[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = list(stmt.targets), stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if not targets or value is None:
            continue
        tname = targets[0].id if isinstance(targets[0], ast.Name) else ""
        if tname == "TRACE_TRAILER_BYTES":
            v = _const_int(value)
            if v is not None:
                table.trailer = v
        elif tname == "REDIRECT_PREFIX" and isinstance(value, ast.Tuple):
            fields = [_field_tuple(e) for e in value.elts]
            if all(f is not None for f in fields):
                prefix = tuple(f for f in fields if f is not None)
        elif tname == "SCHEMA_HISTORY" and isinstance(value, ast.Dict):
            table.history_line = stmt.lineno
            for k, v2 in zip(value.keys, value.values):
                kv = _const_int(k) if k is not None else None
                if kv is not None and isinstance(v2, ast.Constant) and \
                        isinstance(v2.value, str):
                    table.history[kv] = v2.value
        elif tname == "SCHEMAS" and isinstance(value, ast.Tuple):
            for call in value.elts:
                if not isinstance(call, ast.Call):
                    continue
                fn = dotted(call.func) or ""
                if fn.split(".")[-1] not in ("schema", "_redirect"):
                    continue
                if not call.args:
                    continue
                msg = _msgtype_name(call.args[0])
                if msg is None:
                    continue
                fields = [f for a in call.args[1:]
                          if (f := _field_tuple(a)) is not None]
                if fn.split(".")[-1] == "_redirect":
                    fields = list(prefix) + fields
                raw: Optional[str] = None
                gate_appended = 0
                for kw in call.keywords:
                    if kw.arg == "raw" and isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str):
                        raw = kw.value.value
                    elif kw.arg == "gate_appended":
                        gate_appended = _const_int(kw.value) or 0
                table.entries[msg] = _SchemaEntry(
                    msg, table.types.get(msg, 0),
                    tuple(k for _n, k in fields), raw, gate_appended,
                    call.lineno)
    return table, schema_mod


# -- statement-order traversal ------------------------------------------------
#
# R7's sequence checks linearize a function body: statements in source
# order, each contributing only its OWN expressions (``_shallow_nodes``),
# with compound statements recursed separately — so a read inside a loop
# or try-block is counted exactly once, in position.


def _stmts_in_order(body: list[ast.stmt]) -> Iterator[ast.stmt]:
    """Yield statements in source order, descending into compound bodies
    (If/For/While/With/Try) but never into nested def/class bodies."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if isinstance(sub, list) and sub and isinstance(
                    sub[0], ast.stmt):
                yield from _stmts_in_order(sub)
        for h in getattr(stmt, "handlers", []):
            yield from _stmts_in_order(h.body)


def _shallow_nodes(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Every expression node belonging directly to ``stmt`` — child
    statements excluded (they are yielded by _stmts_in_order on their
    own turn, so nothing is visited twice)."""
    todo: list[ast.AST] = []
    for _field, value in ast.iter_fields(stmt):
        if isinstance(value, list):
            todo.extend(v for v in value
                        if isinstance(v, ast.AST)
                        and not isinstance(v, (ast.stmt, ast.excepthandler)))
        elif isinstance(value, ast.AST):
            todo.append(value)
    while todo:
        node = todo.pop()
        yield node
        todo.extend(c for c in ast.iter_child_nodes(node)
                    if not isinstance(c, ast.stmt))


def _append_chains(stmt: ast.stmt) -> list[tuple[str, list[str]]]:
    """(base var, [append kinds in eval order]) for every append chain in
    one statement's own expressions.  ``#raw`` marks append_bytes (a
    raw-region write)."""
    from goworld_tpu_torch.proto.schema import APPEND_TO_KIND

    def is_append(n: ast.AST) -> bool:
        return (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr.startswith("append_"))

    calls = [n for n in _shallow_nodes(stmt) if is_append(n)]
    # a call that appears as another append's receiver is an inner chain
    # link; the remaining calls are chain ROOTS (outermost links)
    inner = {id(c.func.value) for c in calls  # type: ignore[union-attr]
             if is_append(c.func.value)}  # type: ignore[union-attr]
    out: list[tuple[str, list[str]]] = []
    for root in sorted((c for c in calls if id(c) not in inner),
                       key=lambda c: (c.lineno, c.col_offset)):
        chain: list[ast.Call] = []
        cur: ast.AST = root
        while is_append(cur):
            chain.append(cur)  # type: ignore[arg-type]
            cur = cur.func.value  # type: ignore[union-attr]
        base = dotted(cur)
        if base is None:
            continue
        kinds = [APPEND_TO_KIND.get(
            c.func.attr, "#raw" if c.func.attr == "append_bytes"
            else f"?{c.func.attr}")
            for c in reversed(chain)]  # eval order: innermost first
        out.append((base, kinds))
    return out


def _packet_helpers(mod: ParsedModule) -> dict[str, list[str]]:
    """Defs that build one Packet, append fixed kinds, and return it —
    resolvable as pack-prefix seeds (conn.py ``_client_packet``)."""
    out: dict[str, list[str]] = {}
    for _scope, fn in walk_scoped(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        var: Optional[str] = None
        kinds: list[str] = []
        returned = False
        for stmt in _stmts_in_order(fn.body):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    isinstance(stmt.value, ast.Call) and \
                    (dotted(stmt.value.func) or "").split(".")[-1] == \
                    "Packet" and not stmt.value.args:
                var = stmt.targets[0].id
            for base, ks in _append_chains(stmt):
                if base == var:
                    kinds.extend(ks)
            if isinstance(stmt, ast.Return) and var is not None and \
                    isinstance(stmt.value, ast.Name) and \
                    stmt.value.id == var:
                returned = True
        if var is not None and returned:
            out[fn.name] = kinds
    return out


class _PackSite:
    __slots__ = ("msg", "kinds", "raw", "line")

    def __init__(self, msg: str, kinds: Optional[list[str]], raw: bool,
                 line: int) -> None:
        self.msg = msg
        self.kinds = kinds
        self.raw = raw
        self.line = line


def _pack_sites(mod: ParsedModule,
                helpers: dict[str, list[str]]) -> list[_PackSite]:
    sites: list[_PackSite] = []
    for _scope, fn in walk_scoped(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        tracked: dict[str, Optional[list[str]]] = {}  # None = raw-built
        for stmt in _stmts_in_order(fn.body):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    isinstance(stmt.value, ast.Call):
                tgt = stmt.targets[0].id
                callee = (dotted(stmt.value.func) or "").split(".")[-1]
                if callee == "Packet":
                    tracked[tgt] = [] if not stmt.value.args else None
                elif callee in helpers:
                    tracked[tgt] = list(helpers[callee])
            for base, ks in _append_chains(stmt):
                cur = tracked.get(base)
                if cur is not None:
                    cur.extend(ks)
            for node in _shallow_nodes(stmt):
                if not isinstance(node, ast.Call):
                    continue
                msg = next((m for a in node.args
                            if (m := _msgtype_name(a)) is not None), None)
                if msg is None:
                    continue
                attr = node.func.attr if isinstance(
                    node.func, ast.Attribute) else ""
                packet_arg: Optional[ast.expr] = None
                for a in node.args:
                    if _msgtype_name(a) is not None:
                        continue
                    if isinstance(a, ast.Name) and a.id in tracked:
                        packet_arg = a
                        break
                    if isinstance(a, ast.Call) and (
                            dotted(a.func) or "").split(".")[-1] == "Packet":
                        packet_arg = a
                        break
                if packet_arg is None:
                    if attr == "send_packet_raw":
                        sites.append(_PackSite(msg, None, True, node.lineno))
                    continue  # forwarding a received packet: not a pack site
                if isinstance(packet_arg, ast.Name):
                    kinds = tracked[packet_arg.id]
                    sites.append(_PackSite(
                        msg, list(kinds) if kinds is not None else None,
                        kinds is None, node.lineno))
                else:  # inline Packet(...) construction
                    if packet_arg.args:
                        sites.append(_PackSite(msg, None, True, node.lineno))
                    else:
                        sites.append(_PackSite(msg, [], False, node.lineno))
    return sites


# -- unpack-side extraction ---------------------------------------------------


def _handler_tables(mod: ParsedModule) -> dict[str, str]:
    """{method qualname: msgtype name} from class-level ``_HANDLERS``
    (or any ``*_HANDLERS``) dict literals mapping MsgType.X to methods."""
    out: dict[str, str] = {}
    for scope, node in walk_scoped(mod.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_HANDLERS")
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            msg = _msgtype_name(k) if k is not None else None
            vname = dotted(v) if v is not None else None
            if msg and vname:
                tail = vname.split(".")[-1]
                qual = f"{scope}.{tail}" if scope else tail
                out[qual] = msg
    return out


def _branch_test_msg(test: ast.expr) -> Optional[str]:
    """``msgtype == MsgType.X`` -> "X"; ``is_gate_redirect(msgtype)`` ->
    the redirect pseudo-type; anything else -> None."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        for side in (test.left, test.comparators[0]):
            msg = _msgtype_name(side)
            if msg is not None:
                return msg
    if isinstance(test, ast.Call):
        d = (dotted(test.func) or "").split(".")[-1]
        if d == "is_gate_redirect":
            return _REDIRECT_ANY
    return None


#: read item: (tag, msgtype-or-"" , varkey, kind).  kind "#rest" =
#: read_rest, "#bytes" = read_bytes, "#reset" = set_read_pos(0).
_ReadItem = tuple[str, str, str, str]


def _read_kind(node: ast.AST, packet_vars: set[str]) -> Optional[
        tuple[str, str]]:
    """(var, kind) when ``node`` is a cursor operation on a tracked
    packet var; kinds ``#rest``/``#bytes``/``#reset`` are markers."""
    from goworld_tpu_torch.proto.schema import READ_TO_KIND

    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return None
    base = dotted(node.func.value)
    if base not in packet_vars:
        return None
    attr = node.func.attr
    if attr in READ_TO_KIND:
        return (base, READ_TO_KIND[attr])
    if attr == "read_rest":
        return (base, "#rest")
    if attr == "read_bytes":
        return (base, "#bytes")
    if attr == "set_read_pos":
        return (base, "#reset")
    return None


def _linear_reads(fn: ast.AST, packet_params: set[str],
                  module_defs: dict[str, ast.AST],
                  depth: int = 0) -> Optional[list[tuple[str, str]]]:
    """Branch-free read sequence [(varkey, kind)] of a helper, inlining
    one further level of same-module calls.  None when the helper
    branches on msgtype (it is then checked standalone, not inlined)."""
    out: list[tuple[str, str]] = []
    vars_ = set(packet_params)
    for stmt in _stmts_in_order(fn.body):
        if isinstance(stmt, ast.If) and _branch_test_msg(stmt.test):
            return None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Call) and \
                (dotted(stmt.value.func) or "").split(".")[-1] == \
                "Packet" and any(
                    isinstance(n, ast.Name) and n.id in vars_
                    for n in ast.walk(stmt.value)):
            vars_.add(stmt.targets[0].id)
        for node in _shallow_nodes(stmt):
            got = _read_kind(node, vars_)
            if got is not None:
                out.append(got)
                continue
            if depth == 0 and isinstance(node, ast.Call):
                out.extend(_maybe_inline(node, vars_, module_defs, depth))
    return out


def _maybe_inline(node: ast.Call, packet_vars: set[str],
                  module_defs: dict[str, ast.AST],
                  depth: int) -> list[tuple[str, str]]:
    """Reads a same-module helper performs on a packet passed to it,
    re-keyed onto the caller's variable."""
    tail = (dotted(node.func) or "").split(".")[-1]
    target = module_defs.get(tail)
    if target is None:
        return []
    pos = next((i for i, a in enumerate(node.args)
                if isinstance(a, ast.Name) and a.id in packet_vars), None)
    if pos is None:
        return []
    arg = node.args[pos]
    assert isinstance(arg, ast.Name)
    params = [a.arg for a in _all_args(target)]
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    if pos >= len(params):
        return []
    sub = _linear_reads(target, {params[pos]}, module_defs, depth + 1)
    if sub is None:
        return []
    return [(arg.id, kind) for _var, kind in sub]


def _unpack_sequences(mod: ParsedModule) -> list[tuple[str, str, int,
                                                       list[list[str]]]]:
    """Per checked function: (msgtype name, symbol, line, read segments).

    A function contributes when it appears in a ``*_HANDLERS`` table (its
    whole body reads that one msgtype) and/or contains ``msgtype ==
    MsgType.X`` branches (reads inside the branch attribute to X; reads
    outside attribute to every msgtype the function handles).  Segments
    split on ``set_read_pos(0)`` and on peek-vars built via
    ``Packet(packet.payload)``; each is prefix-checked from offset 0."""
    tables = _handler_tables(mod)
    module_defs: dict[str, ast.AST] = {}
    for _scope, node in walk_scoped(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_defs.setdefault(node.name, node)

    results: list[tuple[str, str, int, list[list[str]]]] = []
    for scope, fn in walk_scoped(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        qual = f"{scope}.{fn.name}" if scope else fn.name
        table_msg = tables.get(qual)
        packet_params = {a.arg for a in _all_args(fn)
                         if a.arg in ("packet", "pkt")}
        if not packet_params:
            continue

        items: list[_ReadItem] = []
        vars_ = set(packet_params)
        branch_msgs: list[str] = []

        def emit(node: ast.AST, branch: str) -> None:
            got = _read_kind(node, vars_)
            if got is not None:
                items.append((branch, "", got[0], got[1]))
                return
            if isinstance(node, ast.Call):
                for var, kind in _maybe_inline(node, vars_,
                                               module_defs, 0):
                    items.append((branch, "", var, kind))

        def collect(body: list[ast.stmt], branch: str) -> None:
            for stmt in body:
                if isinstance(stmt, ast.If):
                    msg = _branch_test_msg(stmt.test)
                    if msg is not None:
                        if msg not in branch_msgs:
                            branch_msgs.append(msg)
                        collect(stmt.body, msg)
                        collect(stmt.orelse, branch)
                        continue
                    # non-msgtype If: reads in the TEST run on this path
                    for node in ast.walk(stmt.test):
                        emit(node, branch)
                    collect(stmt.body, branch)
                    collect(stmt.orelse, branch)
                    continue
                if isinstance(stmt, ast.Assign) and \
                        len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Name) and \
                        isinstance(stmt.value, ast.Call) and \
                        (dotted(stmt.value.func) or ""
                         ).split(".")[-1] == "Packet" and any(
                            isinstance(n, ast.Name) and n.id in vars_
                            for n in ast.walk(stmt.value)):
                    vars_.add(stmt.targets[0].id)
                for node in _shallow_nodes(stmt):
                    emit(node, branch)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if isinstance(sub, list) and sub and isinstance(
                            sub[0], ast.stmt):
                        collect(sub, branch)
                for h in getattr(stmt, "handlers", []):
                    collect(h.body, branch)

        collect(fn.body, "")

        targets = list(branch_msgs)
        if table_msg is not None and table_msg not in targets:
            targets.insert(0, table_msg)
        if not targets:
            continue
        for msg in targets:
            segments: list[list[str]] = []
            seg_of: dict[str, list[str]] = {}
            for branch, _x, var, kind in items:
                if branch not in ("", msg):
                    continue
                if kind == "#reset":
                    seg_of.pop(var, None)
                    continue
                seg = seg_of.get(var)
                if seg is None:
                    seg = seg_of[var] = []
                    segments.append(seg)
                seg.append(kind)
            results.append((msg, qual, fn.lineno, segments))
    return results


def check_r7(modules: list[ParsedModule], root: str) -> list[Violation]:
    from goworld_tpu_torch.proto import schema as engine_schema

    parsed = _parse_schema_table(modules)
    if parsed is None:
        return []
    table, schema_mod = parsed
    out: list[Violation] = []

    # 1. every MsgType member has a schema
    for name, value in sorted(table.types.items()):
        if name not in table.entries:
            out.append(schema_mod.violation(
                "R7", 1,
                f"MsgType.{name} ({value}) has no wire schema — declare "
                f"its payload layout in proto/schema.py"))

    # 2. digest pin: the layout table must match SCHEMA_HISTORY for the
    # CURRENT version — layout edits land as (bump, new digest) pairs.
    if table.version is not None:
        digest = engine_schema.digest_of(
            table.version,
            [(e.name, e.value, e.kinds, e.raw)
             for e in table.entries.values()],
            table.trailer)
        pinned = table.history.get(table.version)
        if pinned is None:
            out.append(schema_mod.violation(
                "R7", table.history_line,
                f"SCHEMA_HISTORY has no digest for PROTO_VERSION "
                f"{table.version} — append the pair (and keep earlier "
                f"entries)"))
        elif pinned != digest:
            out.append(schema_mod.violation(
                "R7", table.history_line,
                f"wire-schema digest {digest} does not match the pinned "
                f"{pinned} for PROTO_VERSION {table.version} — a payload "
                f"layout changed: bump PROTO_VERSION in proto/msgtypes.py "
                f"and append the new (version, digest) pair to "
                f"SCHEMA_HISTORY"))

    # 3. pack sites across the whole package
    packed: set[str] = set()
    for mod in modules:
        if mod.path == _SCHEMA_PATH:
            continue
        helpers = _packet_helpers(mod)
        for site in _pack_sites(mod, helpers):
            sch = table.entries.get(site.msg)
            if sch is None:
                if site.msg in table.types:
                    out.append(mod.violation(
                        "R7", site.line,
                        f"packs MsgType.{site.msg} which has no wire "
                        f"schema in proto/schema.py"))
                continue
            packed.add(site.msg)
            if site.raw:
                if sch.raw is None and sch.kinds:
                    out.append(mod.violation(
                        "R7", site.line,
                        f"MsgType.{site.msg} is sent as a raw payload but "
                        f"its schema declares fields {sch.kinds} — build "
                        f"it with the typed appends or declare a raw "
                        f"region"))
                continue
            kinds = list(site.kinds or [])
            expect = list(sch.kinds)
            if kinds and kinds[-1] == "#raw":
                if sch.raw is None:
                    out.append(mod.violation(
                        "R7", site.line,
                        f"MsgType.{site.msg}: trailing append_bytes but "
                        f"the schema declares no raw region"))
                    continue
                kinds = kinds[:-1]
            ok = kinds == expect or (
                sch.gate_appended
                and kinds == expect[:len(expect) - sch.gate_appended])
            if not ok:
                out.append(mod.violation(
                    "R7", site.line,
                    f"MsgType.{site.msg} packed as {kinds} but the wire "
                    f"schema declares {expect} — sender/receiver drift; "
                    f"fix the site or update proto/schema.py (and bump "
                    f"PROTO_VERSION)"))

    # 4. schema coverage: a declared layout nobody packs is drift too
    for name, e in sorted(table.entries.items()):
        if name not in packed and name in table.types:
            out.append(schema_mod.violation(
                "R7", e.line,
                f"MsgType.{name} has a declared schema but no pack site "
                f"anywhere in the package — dead layout or a sender the "
                f"extractor cannot see (baseline with a reason if so)"))

    # 5. handler-side reads in dispatcher/gate/game/rebalance
    redirect_prefix = ["u16", "cid"]
    for mod in modules:
        if not mod.path.startswith(_R7_UNPACK_PREFIXES):
            continue
        for msg, qual, line, segments in _unpack_sequences(mod):
            if msg == _REDIRECT_ANY:
                expect, raw = redirect_prefix, "redirect-payload"
            else:
                sch = table.entries.get(msg)
                if sch is None:
                    if msg in table.types:
                        out.append(mod.violation(
                            "R7", line,
                            f"handles MsgType.{msg} which has no wire "
                            f"schema in proto/schema.py"))
                    continue
                expect, raw = list(sch.kinds), sch.raw
            for seg in segments:
                err = _match_read_segment(seg, expect, raw)
                if err:
                    out.append(mod.violation(
                        "R7", line,
                        f"{qual} reads MsgType.{msg} as {seg} but the "
                        f"wire schema declares {expect}"
                        f"{' + raw ' + raw if raw else ''} — {err}"))
    return out


def _match_read_segment(seg: list[str], expect: list[str],
                        raw: Optional[str]) -> Optional[str]:
    """A read segment must consume declared fields in order from offset 0
    (stopping early is fine; ``read_rest`` swallows the remainder)."""
    i = 0
    for kind in seg:
        if kind == "#rest":
            return None
        if i >= len(expect):
            if raw and kind == "#bytes":
                continue
            return (f"position {i} reads past the declared layout")
        if kind == "#bytes":
            return (f"position {i}: fixed read_bytes over a structured "
                    f"field {expect[i]!r}")
        if kind != expect[i]:
            return (f"position {i} expects {expect[i]!r}, handler reads "
                    f"{kind!r}")
        i += 1
    return None


CHECKERS = {
    "R1": check_r1,
    "R2": check_r2,
    "R3": check_r3,
    "R4": check_r4,
    "R5": check_r5,
    "R6": check_r6,
    "R7": check_r7,
}
