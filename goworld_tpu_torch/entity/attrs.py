"""Nested attribute tree with change streaming.

Reference parity: ``engine/entity`` attr system — ``MapAttr`` (MapAttr.go:12-19,
set: MapAttr.go:83-116), ``ListAttr`` (ListAttr.go:11-18), per-key flags
(attr.go:5-10), value uniformization (attr.go:39-75: everything becomes
int/float/bool/str or nested Map/List), path computation (attr.go:12-36) and
client push-down (Entity.go:814-917).

Every mutation on a subtree that is client-visible produces one change record
routed to the owning entity, which forwards it to the client proxy — that is
how nested attr edits stream to clients incrementally instead of re-sending
whole trees.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

# Change record kinds pushed to the owner entity.
MAP_CHANGE = "map_change"  # (path, key, value)
MAP_DEL = "map_del"  # (path, key)
MAP_CLEAR = "map_clear"  # (path,)
LIST_CHANGE = "list_change"  # (path, index, value)
LIST_APPEND = "list_append"  # (path, value)
LIST_POP = "list_pop"  # (path,)


def uniform_attr_type(v: Any):
    """Normalize a plain value into attr-storable form (attr.go:39-75)."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, MapAttr) or isinstance(v, ListAttr):
        return v
    if isinstance(v, dict):
        m = MapAttr()
        m.assign(v)
        return m
    if isinstance(v, (list, tuple)):
        l = ListAttr()
        l.extend(v)
        return l
    raise TypeError(f"unsupported attr value type: {type(v)!r}")


def _plain(v: Any):
    """Convert attr values back to plain Python (for wire / storage)."""
    if isinstance(v, MapAttr):
        return v.to_dict()
    if isinstance(v, ListAttr):
        return v.to_list()
    return v


class _AttrNode:
    """Shared parent/owner bookkeeping for Map/List attr nodes."""

    __slots__ = ("parent", "pkey", "_owner_cb", "flag_key")

    def __init__(self) -> None:
        self.parent: _AttrNode | None = None
        self.pkey: Any = None  # key (in parent map) or index (in parent list)
        # Root-only: callback(kind, path, *args) → owning entity.
        self._owner_cb: Callable | None = None
        # Root-only hint: which top-level key this subtree hangs under.
        self.flag_key: str | None = None

    # --- path / owner ------------------------------------------------------

    def _root(self) -> "_AttrNode":
        node = self
        while node.parent is not None:
            node = node.parent
        return node

    def path(self) -> list:
        """Path from root to this node (attr.go:12-36), as [key/index, ...]."""
        out: list = []
        node = self
        while node.parent is not None:
            out.append(node.pkey)
            node = node.parent
        out.reverse()
        return out

    def top_key(self) -> str | None:
        """The top-level key this node lives under (flags are per top key)."""
        node = self
        while node.parent is not None:
            if node.parent.parent is None:
                return node.pkey if isinstance(node.pkey, str) else None
            node = node.parent
        return None

    def _notify(self, kind: str, *args) -> None:
        root = self._root()
        if root._owner_cb is not None:
            root._owner_cb(kind, self.path(), *args)

    def _adopt(self, v: Any, key: Any) -> None:
        if isinstance(v, (MapAttr, ListAttr)):
            if v.parent is not None or v._owner_cb is not None:
                raise ValueError("attr subtree already attached elsewhere")
            v.parent = self
            v.pkey = key

    @staticmethod
    def _release(v: Any) -> None:
        if isinstance(v, (MapAttr, ListAttr)):
            v.parent = None
            v.pkey = None


class MapAttr(_AttrNode):
    """String-keyed attribute map (MapAttr.go:12-19)."""

    __slots__ = ("_data",)

    def __init__(self) -> None:
        super().__init__()
        self._data: dict[str, Any] = {}

    # --- mutation ----------------------------------------------------------

    def set(self, key: str, value: Any) -> None:
        v = uniform_attr_type(value)
        old = self._data.get(key)
        self._release(old)
        self._adopt(v, key)
        self._data[key] = v
        self._notify(MAP_CHANGE, key, _plain(v))

    __setitem__ = set

    def set_default(self, key: str, value: Any):
        if key not in self._data:
            self.set(key, value)
        return self._data[key]

    def delete(self, key: str) -> None:
        if key in self._data:
            self._release(self._data.pop(key))
            self._notify(MAP_DEL, key)

    __delitem__ = delete

    def clear(self) -> None:
        for v in self._data.values():
            self._release(v)
        self._data.clear()
        self._notify(MAP_CLEAR)

    def assign(self, d: dict) -> None:
        for k, v in d.items():
            self.set(k, v)

    # --- access ------------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._data.get(key, default)
        return int(v) if v is not None else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._data.get(key, default)
        return float(v) if v is not None else default

    def get_str(self, key: str, default: str = "") -> str:
        v = self._data.get(key, default)
        return str(v) if v is not None else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._data.get(key, default)
        return bool(v) if v is not None else default

    def get_map(self, key: str) -> "MapAttr":
        """Get-or-create a nested MapAttr."""
        v = self._data.get(key)
        if not isinstance(v, MapAttr):
            v = MapAttr()
            self.set(key, v)
        return v

    def get_list(self, key: str) -> "ListAttr":
        v = self._data.get(key)
        if not isinstance(v, ListAttr):
            v = ListAttr()
            self.set(key, v)
        return v

    def has(self, key: str) -> bool:
        return key in self._data

    __contains__ = has

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    # --- conversion --------------------------------------------------------

    def to_dict(self) -> dict:
        return {k: _plain(v) for k, v in self._data.items()}

    def to_dict_filtered(self, keys) -> dict:
        return {k: _plain(v) for k, v in self._data.items() if k in keys}

    def __repr__(self) -> str:
        return f"MapAttr({self.to_dict()!r})"


class ListAttr(_AttrNode):
    """Index-addressed attribute list (ListAttr.go:11-18)."""

    __slots__ = ("_data",)

    def __init__(self) -> None:
        super().__init__()
        self._data: list[Any] = []

    # --- mutation ----------------------------------------------------------

    def append(self, value: Any) -> None:
        v = uniform_attr_type(value)
        self._adopt(v, len(self._data))
        self._data.append(v)
        self._notify(LIST_APPEND, _plain(v))

    def extend(self, values) -> None:
        for v in values:
            self.append(v)

    def set(self, index: int, value: Any) -> None:
        v = uniform_attr_type(value)
        old = self._data[index]
        self._release(old)
        self._adopt(v, index)
        self._data[index] = v
        self._notify(LIST_CHANGE, index, _plain(v))

    __setitem__ = set

    def pop(self) -> Any:
        v = self._data.pop()
        self._release(v)
        self._notify(LIST_POP)
        return _plain(v)

    # --- access ------------------------------------------------------------

    def __getitem__(self, index: int) -> Any:
        return self._data[index]

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def to_list(self) -> list:
        return [_plain(v) for v in self._data]

    def __repr__(self) -> str:
        return f"ListAttr({self.to_list()!r})"
