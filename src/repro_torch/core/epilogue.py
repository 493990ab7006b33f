"""Epilogue specifications: the dense per-model compute around the sparse
aggregation.

Counterpart of ``repro/core/epilogue.py``.  GCN's layer is
``Y = A (X W) + b`` (kind ``"linear"``): the bias seeds the accumulator,
so its epilogue costs nothing beyond the aggregation.  SAGE's dual
epilogue and GIN's MLP come with their models (ROADMAP slice B); asking
for them raises ``NotImplementedError`` naming that slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EpilogueSpec:
    """Shape of the dense epilogue around one layer's aggregation: ``kind``
    is "linear" (GCN), "dual" (SAGE) or "mlp" (GIN).  The reference's
    further fields (bias, activation, the MLP's widths and structure) come
    with the models that read them."""
    kind: str

    @property
    def free_transform(self) -> bool:
        """True when the epilogue computes H = X W anyway (GIN's
        transform-first MLP), so unfused candidates are not charged for
        it; never for GCN's."""
        return self.kind == "mlp"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (only GCN's linear epilogue): ROADMAP "
        "slice B item 9")


def layer_epilogues(model: str, dims: list, hidden: int) -> tuple:
    """Per-layer epilogue specs for ``model`` over its width chain
    ``dims`` (``[in_dim, hidden, ..., n_classes]``)."""
    if model != "gcn":
        raise _not_ported(f"the {model!r} epilogue")
    return tuple(EpilogueSpec(kind="linear") for _ in range(len(dims) - 1))


def epilogue_cost(spec: EpilogueSpec | None, n: int, fin: int | None,
                  agg_dim: int, dtype=None, hw=None) -> float:
    """Roofline seconds of the dense epilogue every candidate pays alike:
    0 for none and for GCN's linear one (the bias seeds the accumulator)."""
    if spec is None or hw is None or spec.kind == "linear":
        return 0.0
    raise _not_ported(f"the cost of the {spec.kind!r} epilogue")
