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


def from_jax_params(params_np: Sequence[Mapping[str, np.ndarray]],
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> list[dict[str, torch.Tensor]]:
    """GCN parameters of ``repro.core.gnn.init_model`` (one
    ``dict(w=(in, out), b=(out,))`` per layer, as numpy) as this package's
    parameters: float32 tensors of the same shapes on ``device``."""
    dev = resolve_device(device)
    out = []
    for i, layer in enumerate(params_np):
        if set(layer) != {"w", "b"}:
            raise ValueError(f"layer {i}: expected GCN keys {{'w', 'b'}}, "
                             f"got {sorted(layer)}")
        w = np.asarray(layer["w"], np.float32)
        b = np.asarray(layer["b"], np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: w {w.shape} and b {b.shape} are "
                             "not (in, out) and (out,)")
        out.append(dict(w=torch.from_numpy(w.copy()).to(dev),
                        b=torch.from_numpy(b.copy()).to(dev)))
    return out
