"""Immutable dataclasses that are JAX pytrees.

`dataclass` freezes the class and registers it with
`jax.tree_util.register_dataclass`: fields are pytree leaves unless
declared with `field(pytree_node=False)`, in which case they are static
metadata (part of the tree structure, so they must be hashable).
`.replace(**updates)` returns a copy with some fields changed (a class
may define its own `replace`, which is then kept). Frozen
dataclasses compare and hash by value, so configs built on this can be
passed as `static_argnames`.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **updates):
    """A copy with the given fields replaced."""
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Freeze `cls` into a dataclass and register it as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    if "replace" not in cls.__dict__:
        cls.replace = _replace
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls
