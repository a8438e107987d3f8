"""Columnar ECS attributes: declarative per-type slab columns + fusable
per-class tick programs.

The reference engine's unit of state is the Entity with dict-shaped ATTRS
(Entity.go:814-917); the slabs made position/sync state columnar, but numeric
game attrs (health, score, cooldowns) still lived in per-entity Python
dicts. This module closes that gap ("The Essence of Entity Component
System", PAPERS.md):

- ``EntityTypeDesc.define_attr(name, "Column", dtype=..., default=...)``
  declares a numeric attr whose storage is a process-wide slab column
  (entity/slabs.py) indexed by the entity's slot. Per-entity reads and
  writes keep the ordinary attrs surface — ``e.attrs["hp"]``,
  ``e.attrs.set("hp", 5)``, ``to_dict()`` — via :class:`ColumnBackedMapAttr`,
  which proxies Column keys to the column and leaves every other key in
  the dict exactly as before. Because ``to_dict`` merges column values,
  Column attrs ride the EXISTING migrate/freeze msgpack blob and the
  persistence snapshots with zero wire-format changes (the schema digest
  stays pinned — tests/test_rebalance.py).

- :func:`columnar_tick` lifts a pure per-entity numeric function over
  (x, y, z, yaw, dt, *columns) into an ``on_tick_batch`` classmethod —
  the generalization of ``slabs.vmapped_position_tick`` to declared
  Column attrs — and tags it with a :class:`FusedProgram` so the batched
  AOI service can run the SAME function INSIDE the engine step dispatch
  (``[aoi] fuse_logic``): steady-state ticks then run move + entity logic
  + neighbor interest as ONE device step (see ops/neighbor.py
  ``_apply_fused_logic`` and aoi/batched.py for the delivery contract).
  The function is elementwise, so both paths call it on whole torch
  tensors on the runtime's device, through the same
  ``ops.neighbor._fused_program_apply``: the fused and unfused
  trajectories come from the same arithmetic.

Client streaming: a per-entity ``set()`` on a Column attr notifies the
normal attr-change stream (Client/AllClients flags keep working); batch
writes (``SlabTickView.set_col`` or the fused step) are server-side state
updates and do not stream per-change — by design, exactly like position,
which has its own vectorized sync channel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from goworld_tpu_torch.entity.attrs import MAP_CHANGE, MapAttr

# Column dtypes are numeric-only: columns exist to vectorize and to ride
# the device step; strings/blobs stay ordinary dict attrs.
_ALLOWED_DTYPES = ("float32", "float64", "int32", "int64", "bool")


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """One declared attr column: name, numpy dtype name, default value.

    Frozen + comparable: two entity types may declare the same column name
    only with an identical spec (the storage is one process-wide array)."""

    name: str
    dtype: str = "float32"
    default: float = 0.0

    def __post_init__(self) -> None:
        if self.dtype not in _ALLOWED_DTYPES:
            raise ValueError(
                f"Column {self.name!r}: dtype must be one of "
                f"{_ALLOWED_DTYPES}, got {self.dtype!r}"
            )

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    def to_python(self, value: Any) -> Any:
        """Column cell -> plain Python scalar (msgpack/storage-safe)."""
        if self.dtype == "bool":
            return bool(value)
        if self.dtype.startswith("int"):
            return int(value)
        return float(value)


@dataclasses.dataclass(frozen=True)
class FusedProgram:
    """A fusable per-class tick program: ``fn(x, y, z, yaw, dt, *cols) ->
    (x, y, z, yaw, *cols)``, elementwise (it runs on whole tensors), plus
    the Column names it reads and writes (in order). Hashable (fn by
    identity) — the engine records its fused variants per program tuple
    (ops/neighbor.fused_trace_count).
    """

    fn: Callable
    columns: tuple[str, ...] = ()


def _logic_device(slabs):
    """The device a class's unfused tick program runs on: the attached
    batched AOI service's, else the runtime's (``Runtime.logic_device``)."""
    svc = getattr(slabs, "aoi_service", None)
    if svc is not None:
        return svc.device
    from goworld_tpu_torch.entity import entity_manager

    return entity_manager.runtime.logic_device()


def columnar_tick(fn: Callable, columns=()):
    """Lift ``fn(x, y, z, yaw, dt, *cols) -> (x, y, z, yaw, *cols)`` into
    an ``on_tick_batch`` classmethod over every live entity of the class.

    Unfused execution (the default, and the automatic fallback on engines
    without fusion support): ONE call of ``fn`` per class per tick on
    torch tensors on the runtime's device — the slab view's position
    columns plus the declared Column attrs, uploaded — through
    ``ops.neighbor._fused_program_apply``, the function the fused step
    calls, with each output cast to its input's dtype as the fused step
    casts it; results are written back through ``set_position_yaw`` /
    ``set_col`` (sync flags set).

    Fused execution (``[aoi] fuse_logic`` + a single-device or spatially
    sharded batched engine): the SAME ``fn`` runs inside the AOI step
    dispatch and this hook never runs (tests assert
    ``jit_cache_size() == 0`` there). The fused tick applies ``fn`` to the
    dispatched epoch and writes results back at the next dispatch, so
    logic rides the AOI cadence with ``dt`` = inter-dispatch seconds;
    write ``fn`` dt-scaled (an integrator), not per-call-counted.

    The returned hook carries ``prewarm(n, dt, col_dtypes)`` and
    ``jit_cache_size()`` (the freeze→restore warmup surface: PyTorch
    compiles nothing, so prewarm runs the program once on zeros and
    ``jit_cache_size()`` is 1 once the host path has run, else 0), plus
    ``fused_program`` (the fusion tag).
    """
    columns = tuple(columns)
    ncols = len(columns)
    program = FusedProgram(fn, columns)
    state: dict = {}

    def run(device, x, y, z, yaw, dt, cols):
        from goworld_tpu_torch.ops.neighbor import (
            _f32,
            _fused_program_apply,
            upload,
        )

        ins = [upload(a, np.asarray(a).dtype.type, device)
               for a in (x, y, z, yaw, *cols)]
        outs = _fused_program_apply(
            program, *ins[:4], _f32(float(dt), device), tuple(ins[4:]))
        state["ran"] = True
        return tuple(o.to(i.dtype).cpu().numpy() for o, i in zip(outs, ins))

    def hook(cls, view) -> None:
        if len(view) == 0:
            return
        cols = [view.col(c) for c in columns]
        out = run(_logic_device(view._slabs), view.x, view.y, view.z,
                  view.yaw, view.dt, cols)
        view.set_position_yaw(*out[:4])
        for name, arr in zip(columns, out[4:]):
            view.set_col(name, arr)

    def prewarm(n: int, dt: float = 0.05, col_dtypes=None) -> None:
        """Dummy-shaped run at population ``n`` (results discarded); the
        restore path calls this before the cluster re-handshake so the
        first live tick pays no first-use cost (slabs.prewarm_tick_hooks).
        ``col_dtypes`` are the declared columns' slab dtypes (float32
        assumed when omitted)."""
        if n <= 0:
            return
        from goworld_tpu_torch.entity import entity_manager

        z = np.zeros(n, np.float32)
        dts = col_dtypes or ("float32",) * ncols
        cols = [np.zeros(n, np.dtype(d)) for d in dts]
        run(entity_manager.runtime.logic_device(), z, z, z, z, dt, cols)

    def jit_cache_size() -> int:
        """1 once the unfused host path has run (or been prewarmed), else
        0 — and 0 FOREVER while the class runs fused, which is the
        one-launch regression gate's assertion."""
        return int(state.get("ran", False))

    hook.prewarm = prewarm
    hook.jit_cache_size = jit_cache_size
    hook.fused_program = program
    return classmethod(hook)


class ColumnBackedMapAttr(MapAttr):
    """Root attrs map for entity types with Column attrs.

    Column keys proxy to the entity's slab column row; everything else is
    the plain dict MapAttr. Always the ROOT of the attr tree (columns are
    top-level keys by construction), so ``path()`` is empty for column
    notifications and the client push-down sees ordinary MAP_CHANGEs.

    After the entity's slot is released (destroy), reads fall back to a
    snapshot taken at release time — same contract as the entity's
    ``_final_pos_yaw``."""

    __slots__ = ("_entity", "_slabs", "_colspecs", "_final", "_primed")

    def __init__(self, entity, slabs, colspecs: dict[str, ColumnSpec]) -> None:
        super().__init__()
        self._entity = entity
        self._slabs = slabs
        self._colspecs = colspecs
        self._final: dict[str, Any] | None = None
        self._primed: dict[str, Any] | None = None

    # --- column cell access -------------------------------------------------

    def _col_get(self, key: str) -> Any:
        primed = self._primed
        if primed is not None and key in primed:
            return primed[key]
        spec = self._colspecs[key]
        slot = self._entity._slot
        if slot < 0:
            if self._final is not None and key in self._final:
                return self._final[key]
            return spec.to_python(spec.default)
        return spec.to_python(self._slabs.columns[key][slot])

    def _col_set(self, key: str, value: Any) -> None:
        if self._primed is not None:
            # A write inside a primed window (an overridden snapshot hook
            # mutating state) must be visible to subsequent reads.
            self._primed.pop(key, None)
        spec = self._colspecs[key]
        slot = self._entity._slot
        if slot < 0:
            if self._final is None:
                self._final = {}
            self._final[key] = spec.to_python(value)
            return
        self._slabs.columns[key][slot] = value
        # Protect the write from an in-flight fused tick's writeback
        # (aoi/batched.py _consume_fused): host writes win.
        self._slabs.fused_dirty[slot] = True

    def prime_columns(self, values: dict[str, Any]) -> None:
        """Install a batch-gathered column value cache (columnar batch
        persistence, entity/entity_manager.py): within the primed window
        every column read returns the pre-gathered plain-Python value
        instead of touching the slab row, so a per-type snapshot round
        costs ONE fancy-index gather per column instead of one slab read
        per entity per key. Values must be exactly what ``to_python``
        would return (the gather uses ndarray.tolist(), which performs
        the identical widening) — bit-identity of freeze/migrate blobs
        is asserted by tests/test_columns.py."""
        self._primed = values

    def unprime_columns(self) -> None:
        self._primed = None

    def _snapshot_columns(self) -> None:
        """Called by Entity._release_slab_slot just before the slot goes:
        post-destroy reads (late saves, diagnostics) stay valid."""
        self._final = {k: self._col_get(k) for k in self._colspecs}

    # --- mutation (column keys intercepted) ---------------------------------

    def set(self, key: str, value: Any) -> None:
        if key in self._colspecs:
            self._col_set(key, value)
            self._notify(MAP_CHANGE, key, self._col_get(key))
            return
        super().set(key, value)

    __setitem__ = set

    def set_default(self, key: str, value: Any):
        if key in self._colspecs:
            return self._col_get(key)  # a column always has a value
        return super().set_default(key, value)

    def delete(self, key: str) -> None:
        if key in self._colspecs:
            raise ValueError(
                f"Column attr {key!r} cannot be deleted (slab storage); "
                f"set it to its default instead")
        super().delete(key)

    __delitem__ = delete

    def clear(self) -> None:
        for key, spec in self._colspecs.items():
            self._col_set(key, spec.default)
        super().clear()

    # --- access (columns merged) --------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._colspecs:
            return self._col_get(key)
        return super().get(key, default)

    def __getitem__(self, key: str) -> Any:
        if key in self._colspecs:
            return self._col_get(key)
        return super().__getitem__(key)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        return int(v) if v is not None else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        return float(v) if v is not None else default

    def get_str(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return str(v) if v is not None else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        return bool(v) if v is not None else default

    def has(self, key: str) -> bool:
        return key in self._colspecs or super().has(key)

    __contains__ = has

    def keys(self):
        return list(self._colspecs) + list(self._data.keys())

    def items(self):
        for k in self._colspecs:
            yield k, self._col_get(k)
        yield from self._data.items()

    def __len__(self) -> int:
        return len(self._colspecs) + len(self._data)

    def __iter__(self):
        return iter(self.keys())

    # --- conversion (migrate/freeze/persist ride these) ---------------------

    def to_dict(self) -> dict:
        out = {k: self._col_get(k) for k in self._colspecs}
        out.update(super().to_dict())
        return out

    def to_dict_filtered(self, keys) -> dict:
        out = {k: self._col_get(k) for k in self._colspecs if k in keys}
        out.update(super().to_dict_filtered(keys))
        return out


def make_attr_root(desc, entity) -> MapAttr:
    """The attr root for a fresh/restored entity: column-backed when the
    type declares Column attrs, the plain MapAttr otherwise (zero overhead
    for column-free types — the common case stays exactly as before)."""
    colspecs = getattr(desc, "column_attrs", None)
    if colspecs:
        return ColumnBackedMapAttr(entity, entity._slabs, colspecs)
    return MapAttr()
