"""Frozen dataclasses registered as JAX pytrees.

Fields are pytree children unless declared ``field(pytree_node=False)``;
those are static metadata (hashable, part of the jit cache key).
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
