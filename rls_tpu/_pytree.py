"""Pytree-dataclass machinery used by every config/state object in rls_tpu.

The reference library (RegularizedLeastSquares.jl) models "solver = mutable
config + mutable state" (e.g. /root/reference/src/FISTA.jl:3-27). The
JAX translation is "solver = frozen pytree config, state = frozen
pytree of arrays", so that whole solvers can be passed through `jax.jit`,
`jax.vmap` and `jax.lax.while_loop` as ordinary pytrees. Static (hashable,
non-traced) fields are marked with ``static_field()`` and become part of the
jit cache key; array fields are traced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")

__all__ = ["pytree_dataclass", "static_field", "field", "replace"]


def static_field(default: Any = dataclasses.MISSING, **kwargs):
    """A dataclass field treated as static (hashable) metadata by JAX."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    if default is dataclasses.MISSING:
        return dataclasses.field(metadata=metadata, **kwargs)
    return dataclasses.field(default=default, metadata=metadata, **kwargs)


def field(default: Any = dataclasses.MISSING, **kwargs):
    """A regular (traced) dataclass field."""
    if default is dataclasses.MISSING:
        return dataclasses.field(**kwargs)
    return dataclasses.field(default=default, **kwargs)


def pytree_dataclass(cls: type[T]) -> type[T]:
    """Decorator: frozen dataclass registered as a JAX pytree.

    Fields with ``metadata={"static": True}`` are registered as meta fields
    (auxiliary data, must be hashable); all other fields are children.
    """
    cls = dataclasses.dataclass(frozen=True, eq=False)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls


def replace(obj: T, **changes: Any) -> T:
    """`dataclasses.replace` re-export (update frozen pytree dataclasses)."""
    return dataclasses.replace(obj, **changes)
