"""Elastic scaling: re-mesh onto a changed device set and re-place state.

Counterpart of ``repro/distributed/elastic.py``.  Protocol:
  1. pick the largest supported mesh that fits the healthy device count
     (``best_mesh_shape``, through ``plan_rescale``),
  2. rebuild the mesh (``launch/mesh.make_mesh``) and the sharding trees
     (``launch/sharding.tree_shardings``),
  3. restore the latest checkpoint onto the new shardings
     (``CheckpointManager.restore(shardings=...)``), preserving exact
     state,
  4. rescale the global batch as ``plan_rescale`` says and continue
     (``launch/train.train(use_mesh=...)`` does 3 on resume).

Checkpoints are stored unsharded, so any factorization restores.  On one
device the plan is a 1 x 1 mesh; the arithmetic is the reference's for
any count.
"""
from __future__ import annotations

import math


def best_mesh_shape(n_devices: int, model_parallel: int = 16,
                    multi_pod_at: int = 512
                    ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest (pod, data, model) factorization under the device budget.
    Prefers keeping the model axis at ``model_parallel``; degrades it by
    powers of two when the fleet is too small."""
    mp = model_parallel
    while mp > 1 and n_devices < mp:
        mp //= 2
    usable = (n_devices // mp) * mp
    data = usable // mp
    if usable >= multi_pod_at and data % 2 == 0:
        return (2, data // 2, mp), ("pod", "data", "model")
    return (data, mp), ("data", "model")


def plan_rescale(old_devices: int, new_devices: int,
                 global_batch: int) -> dict:
    """How a changed fleet affects the step: keep the global batch
    whenever divisible (per-device batch grows or shrinks), otherwise
    scale it to the nearest divisible value and rescale LR linearly."""
    shape, axes = best_mesh_shape(new_devices)
    n_data = math.prod(shape) // shape[-1]
    if global_batch % n_data == 0:
        gb = global_batch
    else:
        gb = max((global_batch // n_data), 1) * n_data
    return dict(mesh_shape=shape, mesh_axes=axes, global_batch=gb,
                lr_scale=gb / global_batch)
