"""AdaptGear aggregation dispatch + the GCN convolution (paper §3/§4).

Counterpart of ``repro/core/adaptgear.py`` for the GCN read path.
``aggregate`` computes Y = sum_s A_s @ X over the decomposition's
subgraphs with one registry kernel per subgraph.  With ``acc=True`` one
output buffer is threaded through the subgraph list (the kernels' ``y_in``
variants); with ``acc=False`` each subgraph's partial is added
explicitly.  Both give the same sums up to float32 ordering.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import plan as plan_mod
from repro_torch.core.decompose import Decomposed
from repro_torch.kernels.registry import REGISTRY

DEFAULT_KERNELS = ("block_diag", "bell")


def to_reordered(dec: Decomposed, x: torch.Tensor) -> torch.Tensor:
    """Permute node features into community order and pad to n_pad rows."""
    xr = x.index_select(0, dec.inv_perm)
    pad = dec.n_pad - dec.n
    if pad:
        xr = torch.nn.functional.pad(xr, (0, 0, 0, pad))
    return xr


def from_reordered(dec: Decomposed, xr: torch.Tensor) -> torch.Tensor:
    return xr[: dec.n].index_select(0, dec.perm)


def _accumulate(dec: Decomposed, x: torch.Tensor, names: tuple,
                y: torch.Tensor | None, acc: bool) -> torch.Tensor:
    for sub, k in zip(dec.subgraphs, names):
        spec = REGISTRY.get(k)
        payload = sub.formats[k]
        if y is None:
            y = spec.matvec(payload, x)
        elif acc and spec.matvec_acc is not None:
            y = spec.matvec_acc(payload, x, y.contiguous())
        else:
            y = y + spec.matvec(payload, x)
    return y


def aggregate(dec: Decomposed, x: torch.Tensor,
              kernels: Sequence[str] = DEFAULT_KERNELS, *,
              acc: bool = False) -> torch.Tensor:
    """Y = A @ X via per-subgraph kernels (x reordered, (n_pad, F))."""
    names = plan_mod.normalize_layer(dec, kernels)
    return _accumulate(dec, x, names, None, acc)


def aggregate_transform(dec: Decomposed, x: torch.Tensor, w: torch.Tensor,
                        kernels: Sequence[str] = DEFAULT_KERNELS,
                        bias: torch.Tensor | None = None, *,
                        acc: bool = False) -> torch.Tensor:
    """Y = A @ (X W) (+ bias), transform first.

    H = X W is one dense ``torch.matmul`` (the reference leaves it to XLA,
    outside any Pallas kernel); the bias seeds the threaded accumulator."""
    names = plan_mod.normalize_layer(dec, kernels)
    h = x @ w
    y = None
    if bias is not None:
        y = bias.to(x.dtype).expand(x.shape[0], w.shape[-1])
    return _accumulate(dec, h, names, y, acc)


# ---------------------------------------------------------------------------
# Convolution layers
# ---------------------------------------------------------------------------

def _glorot(generator: torch.Generator, shape: tuple) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * lim) - lim


def init_gcn_conv(generator: torch.Generator, in_dim: int, out_dim: int,
                  device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """GCN layer parameters: glorot-uniform ``w`` (in_dim, out_dim) drawn
    from ``generator`` (a CPU generator, so every device gets the same
    numbers) and zero ``b`` (out_dim,)."""
    dev = resolve_device(device)
    return dict(w=_glorot(generator, (in_dim, out_dim)).to(dev),
                b=torch.zeros((out_dim,), dtype=torch.float32, device=dev))


def gcn_conv(params: dict, dec: Decomposed, x: torch.Tensor,
             kernels: Sequence[str], *, acc: bool = False) -> torch.Tensor:
    """GCN layer: Y = Â (X W) + b (Kipf & Welling; Â's norm is baked into
    the decomposition's edge values)."""
    return aggregate_transform(dec, x, params["w"], kernels,
                               bias=params["b"], acc=acc)
