"""Execution plans: per-layer x per-subgraph kernel choices.

Counterpart of ``repro/core/plan.py``.  A :class:`KernelPlan` layer entry
is a tuple of kernel names aligned with ``Decomposed.subgraphs``;
``normalize_layer`` also takes the paper's ``(intra, inter)`` pair and
broadcasts the inter choice over every inter density bucket.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.decompose import Decomposed, Subgraph
from repro_torch.kernels.registry import REGISTRY


def _validate(sub: Subgraph, kernel: str) -> str:
    spec = REGISTRY.get(kernel)            # raises on unknown name
    if not spec.applies_to(sub.kind):
        raise ValueError(
            f"kernel {kernel!r} does not apply to subgraph {sub.name!r} "
            f"(kind={sub.kind!r})")
    # fused kernels alias their unfused counterpart's payload
    if spec.payload_key not in sub.formats:
        raise ValueError(
            f"kernel {kernel!r} has no materialized format on subgraph "
            f"{sub.name!r}; available: {tuple(sub.formats)}")
    return kernel


def normalize_layer(dec: Decomposed, choice: Sequence[str]) -> tuple[str, ...]:
    """One layer's kernel choice as a per-subgraph name tuple: a full
    per-subgraph tuple, or the ``(intra, inter)`` pair broadcast over the
    inter buckets."""
    if isinstance(choice, str):
        raise TypeError("kernel choice must be a sequence of names, "
                        f"got {choice!r}")
    names = tuple(choice)
    n_sub = len(dec.subgraphs)
    if len(names) == 2 and n_sub != 2:
        names = (names[0],) + (names[1],) * (n_sub - 1)
    if len(names) != n_sub:
        raise ValueError(
            f"plan layer has {len(names)} kernels for {n_sub} subgraphs")
    return tuple(_validate(s, k) for s, k in zip(dec.subgraphs, names))


@dataclass(frozen=True)
class KernelPlan:
    """Per-layer x per-subgraph kernel assignment.  ``epilogues``
    optionally records the per-layer ``core.epilogue.EpilogueSpec`` the
    plan was selected under."""
    subgraph_names: tuple      # aligned with Decomposed.subgraphs
    layers: tuple              # tuple[tuple[str, ...], ...]
    epilogues: tuple | None = None   # tuple[EpilogueSpec | None, ...]

    def for_layer(self, i: int) -> tuple:
        return self.layers[i]

    def epilogue_for_layer(self, i: int):
        return self.epilogues[i] if self.epilogues is not None else None

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)

    @classmethod
    def make(cls, dec: Decomposed, choices, n_layers: int | None = None,
             epilogues: tuple | None = None) -> "KernelPlan":
        """Build a validated plan from a KernelPlan (re-validated), one
        layer choice (broadcast to ``n_layers``), or one choice per layer."""
        sub_names = tuple(s.name for s in dec.subgraphs)
        if isinstance(choices, KernelPlan):
            if n_layers is not None and len(choices.layers) != n_layers:
                raise ValueError(f"plan has {len(choices.layers)} layers, "
                                 f"model has {n_layers}")
            return cls(sub_names,
                       tuple(normalize_layer(dec, c) for c in choices.layers),
                       epilogues or choices.epilogues)
        if (isinstance(choices, (tuple, list)) and choices
                and isinstance(choices[0], str)):
            layer = normalize_layer(dec, choices)
            layers = (layer,) * (n_layers or 1)
        else:
            layers = tuple(normalize_layer(dec, c) for c in choices)
            if n_layers is not None and len(layers) != n_layers:
                raise ValueError(
                    f"plan has {len(layers)} layers, model has {n_layers}")
        if epilogues is not None and len(epilogues) != len(layers):
            raise ValueError(
                f"plan has {len(layers)} layers but {len(epilogues)} "
                f"epilogue specs")
        return cls(sub_names, layers, epilogues)
