"""Carry model parameters over from the JAX reference.

``jax.random`` and torch generators give different numbers from one seed,
so a comparison of the two packages starts both from the reference's
parameters, converted to numpy by the caller.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device


# the key set of each ported model's layer
LAYER_KEYS = ({"w", "b"}, {"w_self", "w_neigh", "b"})


def from_jax_params(params_np: Sequence[Mapping[str, np.ndarray]],
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> list[dict[str, torch.Tensor]]:
    """Parameters of ``repro.core.gnn.init_model`` (one dict per layer, as
    numpy: GCN's ``w`` (in, out) and ``b`` (out,), or SAGE's ``w_self``
    and ``w_neigh`` (in, out) and ``b`` (out,)) as this package's
    parameters: float32 tensors of the same shapes on ``device``, each
    with storage of its own (never the caller's arrays).  The result can
    start ``repro_torch.core.gnn.train(params=...)`` directly, which
    copies it and writes into nothing it was given."""
    dev = resolve_device(device)
    out = []
    for i, layer in enumerate(params_np):
        if set(layer) not in LAYER_KEYS:
            raise ValueError(f"layer {i}: expected GCN keys {{'w', 'b'}} or "
                             "SAGE keys {'w_self', 'w_neigh', 'b'}, got "
                             f"{sorted(layer)}")
        arrs = {k: np.asarray(v, np.float32) for k, v in layer.items()}
        b = arrs["b"]
        for k, a in arrs.items():
            if k != "b" and (a.ndim != 2 or b.shape != (a.shape[1],)):
                raise ValueError(f"layer {i}: {k} {a.shape} and b {b.shape} "
                                 "are not (in, out) and (out,)")
        if "w_self" in arrs and arrs["w_self"].shape != arrs["w_neigh"].shape:
            raise ValueError(f"layer {i}: w_self {arrs['w_self'].shape} and "
                             f"w_neigh {arrs['w_neigh'].shape} differ")
        out.append({k: torch.from_numpy(a.copy()).to(dev)
                    for k, a in arrs.items()})
    return out
