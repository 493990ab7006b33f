"""Epilogue specifications: the dense per-model compute around the sparse
aggregation.

Counterpart of ``repro/core/epilogue.py``.  Because aggregation is
linear, each model's weight pushes through it, so the fused kernels
apply:

  linear (GCN)   Y = A (X W) + b
  dual   (SAGE)  Y = X W_self + A (X W_neigh) + b, with the mean
                 normalization baked into the decomposition's edge values
                 (``core.gnn.prepare``): ``mean(A@X) W == (D^-1 A)(X W)``
  mlp    (GIN)   Y = relu((1+eps) S + A (X W1) + b1) W2 + b2,  S = X W1
                 (transform-first: the self term needs S anyway, so the
                 unfused candidates aggregate it for free,
                 ``free_transform``), or, where the raw input is narrower
                 than the MLP's hidden width, aggregate-first
                 Y = MLP((1+eps) X + A X); the selector prices the two
                 against each other (``gin_structure_candidates``)

GCN's bias seeds the accumulator, so its epilogue costs nothing beyond the
aggregation; SAGE's self matmul and GIN's MLP are dense terms every
candidate pays alike (``epilogue_cost``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.kernels.registry import _bytes_el


@dataclass(frozen=True)
class EpilogueSpec:
    """Shape of the dense epilogue around one layer's aggregation.

    ``kind``       -- "linear" (GCN), "dual" (SAGE) or "mlp" (GIN)
    ``bias``       -- the epilogue adds a bias (it seeds the accumulator)
    ``activation`` -- the nonlinearity on the aggregated sum before the
                      epilogue's second stage (mlp: "relu")
    ``mean_norm``  -- the aggregation is degree-normalized, baked into the
                      decomposition's edge values at prepare time
    ``out_dim``    -- mlp only: the second matmul's output width
    ``structure``  -- mlp only: "transform_first" aggregates at the MLP's
                      hidden width with W1 pushed through the aggregation;
                      "aggregate_first" aggregates the raw features and
                      runs the whole MLP after
    ``hidden``     -- mlp aggregate-first only: the MLP's hidden width
                      (that layer's width pair is ``(None, in_dim)``, so
                      the dense terms read the hidden width here)"""
    kind: str
    bias: bool = True
    activation: str | None = None
    mean_norm: bool = False
    out_dim: int = 0
    structure: str = "transform_first"
    hidden: int = 0

    @property
    def free_transform(self) -> bool:
        """True when the epilogue computes H = X W anyway (GIN's
        transform-first MLP, whose self term is S = X W1), so unfused
        candidates are not charged for it; an aggregate-first MLP layer
        aggregates raw features, so no transform is shared there."""
        return self.kind == "mlp" and self.structure == "transform_first"


def layer_epilogues(model: str, dims: list, hidden: int) -> tuple:
    """Per-layer epilogue specs for ``model`` over its width chain
    ``dims`` (``[in_dim, hidden, ..., n_classes]``).  GIN takes the
    decomposition-free structure rule: aggregate-first where the raw input
    is narrower than the MLP's hidden width (``core.gnn.layer_plan_inputs``
    prices the choice where a decomposition exists).  Any other model
    (GAT) aggregates raw features with no fusable epilogue: ``None`` per
    layer, as in the reference."""
    n_layers = len(dims) - 1
    if model == "gcn":
        return tuple(EpilogueSpec(kind="linear") for _ in range(n_layers))
    if model == "sage":
        return tuple(EpilogueSpec(kind="dual", mean_norm=True)
                     for _ in range(n_layers))
    if model == "gin":
        return tuple(gin_layer_spec(dims[i], hidden, dims[i + 1],
                                    structure=("aggregate_first"
                                               if dims[i] < hidden
                                               else "transform_first"))
                     for i in range(n_layers))
    return (None,) * n_layers


def gin_layer_spec(fin: int, hidden: int, out_dim: int,
                   structure: str) -> EpilogueSpec:
    """One GIN layer's EpilogueSpec under ``structure``."""
    return EpilogueSpec(kind="mlp", activation="relu", out_dim=out_dim,
                        structure=structure,
                        hidden=hidden if structure == "aggregate_first" else 0)


def gin_structure_candidates(fin: int, hidden: int, out_dim: int) -> tuple:
    """Both structures of one GIN layer as ``((pair, spec), (pair,
    spec))``: transform-first with the width pair ``(fin, hidden)`` (fused
    kernels compete on A (X W1)), and aggregate-first with ``(None, fin)``
    (raw-width aggregation, fused kernels sit out).
    ``selector.plan_layer_cost`` prices each, the MLP's dense terms
    included."""
    tf = ((fin, hidden), gin_layer_spec(fin, hidden, out_dim,
                                        "transform_first"))
    af = ((None, fin), gin_layer_spec(fin, hidden, out_dim,
                                      "aggregate_first"))
    return tf, af


def epilogue_cost(spec: EpilogueSpec | None, n: int, fin: int | None,
                  agg_dim: int, dtype=np.float32, hw=None) -> float:
    """Roofline seconds of the dense epilogue every candidate pays alike:
    0 for none and for GCN's linear one (the bias seeds the accumulator);
    SAGE's self matmul and combine add; GIN's MLP (transform-first: S =
    X W1, the activation pass and the second matmul at the hidden width;
    aggregate-first: the self add, then the whole MLP after the raw-width
    aggregation)."""
    if spec is None or hw is None or spec.kind == "linear":
        return 0.0
    be = _bytes_el(dtype)
    if spec.kind == "mlp" and spec.structure == "aggregate_first":
        # agg_dim is the raw input width here; the hidden width rides the
        # spec
        h = spec.hidden
        flops = 2.0 * n * agg_dim * h + 2.0 * n * h * spec.out_dim
        bytes_ = (3.0 * n * agg_dim + agg_dim * h + 2.0 * n * h
                  + h * spec.out_dim + n * spec.out_dim) * be
        return (max(flops / hw.peak_flops, bytes_ / hw.hbm_bw)
                + hw.launch_overhead_s)
    if fin is None:
        return 0.0
    if spec.kind == "dual":
        flops = 2.0 * n * fin * agg_dim
        bytes_ = (n * fin + fin * agg_dim + 3.0 * n * agg_dim) * be
    elif spec.kind == "mlp":
        flops = 2.0 * n * fin * agg_dim + 2.0 * n * agg_dim * spec.out_dim
        bytes_ = (n * fin + fin * agg_dim + 4.0 * n * agg_dim
                  + agg_dim * spec.out_dim + n * spec.out_dim) * be
    else:
        raise ValueError(f"unknown epilogue kind {spec.kind!r}")
    return (max(flops / hw.peak_flops, bytes_ / hw.hbm_bw)
            + hw.launch_overhead_s)
