"""Logical-axis -> mesh-axis resolution (counterpart of
``repro/launch/sharding.py``).

Parameters, caches and batches carry *logical* axis names
(``models/lm.py`` ``param_specs``, ``cache_specs``).  ``default_rules``
maps logical names to mesh axes; ``spec_for`` resolves one tensor,
checking divisibility and never using a mesh axis twice within a tensor.
A non-divisible dim falls back to replication (kv_heads = 8 cannot shard
over model = 16), and ``count_unsharded_fallbacks`` reports each such
fallback.  The rules and the resolved specs are the reference's, entry
for entry, on any mesh, abstract ones included.

``PartitionSpec`` and ``NamedSharding`` are the port's own small
counterparts of ``jax.sharding``'s: a tuple of mesh-axis names (a name, a
tuple of names, or None per dim) and a (mesh, spec) pair whose ``place``
puts a tensor on the mesh.  On one device every resolved spec places the
leaf whole on that device (``launch/mesh.py``); a mesh without devices
(abstract) or of several devices cannot place, and ``place`` raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import is_logical
from repro_torch.tree import tree_map


class PartitionSpec(tuple):
    """One tensor's layout: per dim a mesh-axis name, a tuple of names
    (the dim split over their product) or None (replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A tensor's placement: ``spec`` over ``mesh``.  Not a tuple, so a
    tree of them has these as leaves."""
    mesh: Mesh
    spec: PartitionSpec

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the mesh: the whole tensor on its one device.  Raises
        on an abstract mesh, on a mesh of several devices (no DTensor)
        and when the spec names more dims than ``x`` has."""
        if self.mesh.abstract:
            raise ValueError(f"cannot place a tensor on the abstract "
                             f"{self.mesh}: it has no devices")
        if self.mesh.size != 1:
            raise ValueError(f"cannot place a tensor on {self.mesh}: the "
                             "port places leaves on one device")
        if len(self.spec) > x.dim():
            raise ValueError(f"spec {self.spec} has {len(self.spec)} dims, "
                             f"the tensor {tuple(x.shape)}")
        return x.to(self.mesh.devices[0])


# default logical->physical rules for the 2-D / 3-D production mesh.
# "embed" FSDP-shards over the data axis (ZeRO-3 style in the reference).
def default_rules(mesh: Mesh, *, shard_seq: bool = False) -> dict:
    has_pod = "pod" in mesh.axis_names
    batch = ("pod", "data") if has_pod else ("data",)
    return {
        "embed": ("data",),
        "mlp": ("model",),
        "qkv": ("model",),
        "kv": ("model",),
        "heads": ("model",),
        "vocab": ("model",),
        "expert": ("model",),
        "layer": None,
        "batch": batch,
        "seq": ("model",) if shard_seq else None,
        # decode KV/sequence axis: sharded over the batch axes when the
        # batch itself is too small to fill them (long-context decode)
        "kv_seq": batch if shard_seq else None,
    }


def _targets(name, rules: dict, mesh: Mesh) -> tuple:
    """The mesh axes (present in ``mesh``) that logical ``name`` maps to."""
    target = rules.get(name) if name is not None else None
    if target is None:
        return ()
    tgt = (target,) if isinstance(target, str) else tuple(target)
    return tuple(a for a in tgt if a in mesh.axis_names)


def spec_for(shape: tuple[int, ...], logical: tuple, rules: dict,
             mesh: Mesh) -> PartitionSpec:
    axes: list = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        tgt = tuple(a for a in _targets(name, rules, mesh) if a not in used)
        size = math.prod(mesh.shape[a] for a in tgt) if tgt else 1
        if tgt and dim % size == 0:
            axes.append(tgt if len(tgt) > 1 else tgt[0])
            used.update(tgt)
        else:
            axes.append(None)
    return PartitionSpec(*axes)


def _shape(x) -> tuple:
    return tuple(x.shape)


def tree_shardings(tree_shapes: Any, tree_logical: Any, mesh: Mesh,
                   rules: dict | None = None) -> Any:
    """Resolve a tree of tensors (meta or real) and its matching logical
    spec tree into ``NamedSharding``s (a None spec or leaf: replicated)."""
    rules = rules or default_rules(mesh)

    def resolve(x, logical):
        if x is None or logical is None:
            return NamedSharding(mesh, PartitionSpec())
        return NamedSharding(mesh, spec_for(_shape(x), logical, rules, mesh))

    return tree_map(resolve, tree_shapes, tree_logical,
                    is_leaf=lambda t: t is None or is_logical(t))


def place_tree(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` placed through its ``NamedSharding``."""
    return tree_map(lambda s, x: s.place(x), shardings, tree,
                    is_leaf=lambda t: isinstance(t, NamedSharding))


def batch_specs(batch_shapes: dict, mesh: Mesh,
                rules: dict | None = None) -> dict:
    """Shardings for an input batch: dim 0 of every array is the global
    batch (except ``positions`` (3, B, S), whose batch is dim 1, and
    scalars)."""
    rules = rules or default_rules(mesh)
    out = {}
    for k, v in batch_shapes.items():
        if v is None:
            out[k] = NamedSharding(mesh, PartitionSpec())
            continue
        shape = _shape(v)
        if k == "positions" and len(shape) == 3:
            logical = (None, "batch", None)
        elif len(shape) == 0:
            logical = ()
        else:
            logical = ("batch",) + (None,) * (len(shape) - 1)
        out[k] = NamedSharding(mesh, spec_for(shape, logical, rules, mesh))
    return out


def count_unsharded_fallbacks(tree_shapes, tree_logical, mesh: Mesh,
                              rules: dict | None = None) -> list[str]:
    """Which logical axes fell back to replication (reported by the
    dry-run, so nothing is replicated silently)."""
    rules = rules or default_rules(mesh)
    notes = []

    def walk(path, x, logical):
        if x is None or logical is None:
            return
        for dim, name in zip(_shape(x), logical):
            tgt = _targets(name, rules, mesh)
            size = math.prod(mesh.shape[a] for a in tgt) if tgt else 1
            if size > 1 and dim % size != 0:
                notes.append(f"{path}: {name}={dim} !% {size} -> replicated")

    def rec(path, a, b):
        if b is None or is_logical(b):
            walk(path, a, b)
        elif isinstance(b, dict):
            for k in b:
                rec(f"{path}/{k}", a[k] if a is not None else None, b[k])
        elif isinstance(b, (list, tuple)):
            for i, bb in enumerate(b):
                rec(f"{path}[{i}]", a[i] if a is not None else None, bb)

    rec("", tree_shapes, tree_logical)
    return sorted(set(notes))
