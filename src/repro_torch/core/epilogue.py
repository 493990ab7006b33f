"""Epilogue specifications: the dense per-model compute around the sparse
aggregation.

Counterpart of ``repro/core/epilogue.py``.  Because aggregation is
linear, each model's weight pushes through it, so the fused kernels
apply:

  linear (GCN)   Y = A (X W) + b
  dual   (SAGE)  Y = X W_self + A (X W_neigh) + b, with the mean
                 normalization baked into the decomposition's edge values
                 (``core.gnn.prepare``): ``mean(A@X) W == (D^-1 A)(X W)``

GCN's bias seeds the accumulator, so its epilogue costs nothing beyond the
aggregation; SAGE's self matmul is a dense term every candidate pays
alike (``epilogue_cost``).  GIN's MLP epilogue comes with GIN (ROADMAP
section 1 item 4); asking for it raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.kernels.registry import _bytes_el


@dataclass(frozen=True)
class EpilogueSpec:
    """Shape of the dense epilogue around one layer's aggregation.

    ``kind``      -- "linear" (GCN), "dual" (SAGE) or "mlp" (GIN)
    ``bias``      -- the epilogue adds a bias (it seeds the accumulator)
    ``mean_norm`` -- the aggregation is degree-normalized, baked into the
                     decomposition's edge values at prepare time

    The reference's further fields (activation, the MLP's widths and
    structure) come with GIN, the model that reads them."""
    kind: str
    bias: bool = True
    mean_norm: bool = False

    @property
    def free_transform(self) -> bool:
        """True when the epilogue computes H = X W anyway (GIN's
        transform-first MLP), so unfused candidates are not charged for
        it; never for GCN's or SAGE's."""
        return self.kind == "mlp"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (GCN and SAGE are): ROADMAP section 1 "
        "item 4")


def layer_epilogues(model: str, dims: list, hidden: int) -> tuple:
    """Per-layer epilogue specs for ``model`` over its width chain
    ``dims`` (``[in_dim, hidden, ..., n_classes]``)."""
    n_layers = len(dims) - 1
    if model == "gcn":
        return tuple(EpilogueSpec(kind="linear") for _ in range(n_layers))
    if model == "sage":
        return tuple(EpilogueSpec(kind="dual", mean_norm=True)
                     for _ in range(n_layers))
    raise _not_ported(f"the {model!r} epilogue")


def epilogue_cost(spec: EpilogueSpec | None, n: int, fin: int | None,
                  agg_dim: int, dtype=np.float32, hw=None) -> float:
    """Roofline seconds of the dense epilogue every candidate pays alike:
    0 for none and for GCN's linear one (the bias seeds the accumulator);
    for SAGE's dual one, the self matmul X W_self and the combine add."""
    if spec is None or hw is None or spec.kind == "linear":
        return 0.0
    if spec.kind != "dual":
        raise _not_ported(f"the cost of the {spec.kind!r} epilogue")
    if fin is None:
        return 0.0
    be = _bytes_el(dtype)
    flops = 2.0 * n * fin * agg_dim
    bytes_ = (n * fin + fin * agg_dim + 3.0 * n * agg_dim) * be
    return (max(flops / hw.peak_flops, bytes_ / hw.hbm_bw)
            + hw.launch_overhead_s)
