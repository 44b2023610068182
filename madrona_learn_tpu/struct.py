"""Pytree dataclasses and an immutable mapping.

``PyTreeNode`` subclasses become frozen dataclasses registered as pytrees:
fields are children unless declared with ``field(pytree_node=False)``, in
which case they are static tree metadata. ``.replace(**changes)`` returns a
modified copy.

``FrozenDict`` is an immutable dict pytree. It flattens with its keys
sorted, exactly like a ``dict``, and keeps nested mappings as plain dicts
inside (wrapping them on access), so tree structures and checkpoint layouts
are the same as those of the equivalent nested dicts.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import jax

__all__ = ["PyTreeNode", "field", "FrozenDict", "freeze", "unfreeze"]


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a flag for static (non-pytree) fields."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: subclasses are frozen dataclasses and pytrees."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__()
        dataclasses.dataclass(frozen=True, **kwargs)(cls)
        data, meta = [], []
        for f in dataclasses.fields(cls):
            static = not f.metadata.get("pytree_node", True)
            (meta if static else data).append(f.name)
        jax.tree_util.register_dataclass(
            cls, data_fields=data, meta_fields=meta)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _prepare_freeze(xs):
    if isinstance(xs, FrozenDict):
        return xs._dict
    if not isinstance(xs, dict):
        return xs
    return {k: _prepare_freeze(v) for k, v in xs.items()}


class FrozenDict(Mapping):
    """An immutable dict; nested dicts come back as ``FrozenDict``."""

    __slots__ = ("_dict", "_hash")

    def __init__(self, *args, **kwargs):
        self._dict = _prepare_freeze(dict(*args, **kwargs))
        self._hash = None

    @classmethod
    def _wrap(cls, d):
        out = cls.__new__(cls)
        out._dict = d
        out._hash = None
        return out

    def __getitem__(self, key):
        v = self._dict[key]
        return FrozenDict._wrap(v) if isinstance(v, dict) else v

    def __contains__(self, key):
        return key in self._dict

    def __iter__(self):
        return iter(self._dict)

    def __len__(self):
        return len(self._dict)

    def __repr__(self):
        return f"FrozenDict({self._dict!r})"

    def __reduce__(self):
        return FrozenDict, (self.unfreeze(),)

    def __hash__(self):
        if self._hash is None:
            h = 0
            for key, value in self.items():
                h ^= hash((key, value))
            self._hash = h
        return self._hash

    def copy(self, add_or_replace: Mapping | None = None):
        """A new FrozenDict with entries added or replaced."""
        return FrozenDict({**self._dict, **unfreeze(add_or_replace or {})})

    def pop(self, key):
        """``(copy without key, value of key)``."""
        value = self[key]
        rest = dict(self._dict)
        del rest[key]
        return FrozenDict._wrap(rest), value

    def unfreeze(self) -> dict:
        return unfreeze(self)


def freeze(xs: Mapping) -> FrozenDict:
    return FrozenDict(xs)


def unfreeze(x: Any) -> Any:
    """Nested ``FrozenDict``/dict -> nested plain dicts (leaves untouched)."""
    if isinstance(x, FrozenDict):
        x = x._dict
    if isinstance(x, dict):
        return {k: unfreeze(v) for k, v in x.items()}
    return x


def _flatten_with_keys(fd: FrozenDict):
    keys = sorted(fd._dict)
    return (tuple((jax.tree_util.DictKey(k), fd._dict[k]) for k in keys),
            tuple(keys))


jax.tree_util.register_pytree_with_keys(
    FrozenDict,
    _flatten_with_keys,
    lambda keys, values: FrozenDict._wrap(dict(zip(keys, values))),
)
