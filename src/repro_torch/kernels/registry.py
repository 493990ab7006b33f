"""Kernel registry: the single place an aggregation kernel is defined.

Counterpart of ``repro/kernels/registry.py``.  Every aggregation kernel
registers one :class:`KernelSpec`:

  name       -- dispatch key (stored in KernelPlans)
  kinds      -- subgraph kinds it applies to: ``"diag"`` (the block-diagonal
                intra-community tier) and/or ``"offdiag"`` (inter tiers)
  build      -- host-side payload builder run once during decomposition:
                ``build(coo, coo_t, block_size, stats) -> payload``, or None
                for a spec that aliases another's payload (``payload_of``)
  matvec     -- ``matvec(payload, x) -> A @ x`` (None for fused specs)
  matvec_acc -- optional ``matvec_acc(payload, x, y_in) -> y_in + A @ x``
  fused_matvec(_acc) -- fused transform+aggregate
                ``(payload, x, w[, y_in]) -> A @ (x @ w) [+ y_in]``
  cost       -- analytic cost for the cost-model selector (not ported yet:
                the stub raises)

Registered here: ``block_diag`` and ``bell`` (hand CUDA kernels), ``ell``
and ``coo`` (plain PyTorch gather / ``index_add_``), and the fused
``block_diag_fused`` and ``bell_fused`` (hand CUDA kernels over the
``block_diag`` and ``bell`` payloads).  csr, sell_cs and tcgnn_tile come
with later slices (ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core import formats
from repro_torch.kernels import ops

DIAG = "diag"          # intra-community subgraph (block-diagonal)
OFFDIAG = "offdiag"    # inter-community subgraph / density bucket


@dataclass(frozen=True)
class KernelSpec:
    name: str
    kinds: frozenset
    build: Callable[[formats.COO, formats.COO, int, dict], Any] | None
    matvec: Callable[[Any, Any], Any] | None
    cost: Callable[[Any, Any, Any, Any], float]
    needs_transpose: bool = False   # build consumes coo_t
    matvec_acc: Callable[[Any, Any, Any], Any] | None = None
    fused_matvec: Callable[..., Any] | None = None
    fused_matvec_acc: Callable[..., Any] | None = None
    payload_of: str | None = None   # alias another kernel's format payload
    doc: str = ""

    def applies_to(self, kind: str) -> bool:
        return kind in self.kinds

    @property
    def fused(self) -> bool:
        return self.fused_matvec is not None

    @property
    def payload_key(self) -> str:
        """Key into Subgraph.formats holding this kernel's payload."""
        return self.payload_of or self.name


class KernelRegistry:
    """Ordered name -> KernelSpec mapping with per-subgraph-kind views."""

    def __init__(self):
        self._specs: dict[str, KernelSpec] = {}

    def register(self, spec: KernelSpec) -> KernelSpec:
        if spec.name in self._specs:
            raise ValueError(f"kernel {spec.name!r} already registered")
        if spec.payload_of is not None and spec.payload_of not in self._specs:
            raise ValueError(
                f"kernel {spec.name!r} aliases unregistered payload "
                f"{spec.payload_of!r}")
        self._specs[spec.name] = spec
        return spec

    def get(self, name: str) -> KernelSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown kernel {name!r}; registered: {self.names()}"
            ) from None

    def names(self) -> tuple[str, ...]:
        return tuple(self._specs)

    def candidates(self, kind: str) -> tuple[KernelSpec, ...]:
        """Specs applicable to a subgraph kind, in registration order,
        fused aliases included."""
        return tuple(s for s in self._specs.values() if s.applies_to(kind))


REGISTRY = KernelRegistry()


# ---------------------------------------------------------------------------
# Per-bucket blocked-ELL tiling (chosen at build time from the tier's edges)
# ---------------------------------------------------------------------------

def _bell_pick_block(coo: formats.COO, base_block: int) -> int:
    """Blocked-ELL block size for one density bucket.

    Candidates are 1, 2 and 4 times the community size that still divide
    the padded node count.  Score per candidate: ``K * sqrt(Bb)``, the
    reference's trade between padded tile volume and tile efficiency; the
    port keeps the rule so its payloads equal the reference's."""
    n_pad = coo.n_rows
    rows = formats._np(coo.rows)
    cols = formats._np(coo.cols)
    if len(rows) == 0:
        return base_block
    best, best_score = base_block, None
    for mult in (1, 2, 4):
        Bb = base_block * mult
        if n_pad % Bb:
            continue
        nbc = n_pad // Bb
        brow = rows // Bb
        keys = np.unique(brow.astype(np.int64) * nbc + cols // Bb)
        per_row = np.bincount(keys // nbc, minlength=n_pad // Bb)
        K = max(int(per_row.max()), 1)
        score = K * float(np.sqrt(Bb))
        if best_score is None or score < best_score:
            best, best_score = Bb, score
    return best


def _bell_f_cap(block_size: int) -> int:
    """The reference's feature-tile cap (a TPU VMEM budget).  The CUDA
    kernel does not read it; it is kept because it is part of the
    ``BlockELL`` payload the parity tests compare."""
    budget_floats = (4 << 20) // 4 // 2
    cap = (budget_floats - block_size * block_size) // (3 * block_size)
    return int(max(128, min(1024, (cap // 128) * 128)))


def _bell_build(coo, coo_t, block_size, stats):
    """Full-batch blocked-ELL payload ``(bell, bell_t)`` with the
    data-dependent per-bucket block size and K."""
    if (stats or {}).get("edge_budget"):
        raise NotImplementedError(
            "budget-capped blocked-ELL (mini-batch) is not ported yet: "
            "ROADMAP slice C")
    Bb = _bell_pick_block(coo, block_size)
    cap = _bell_f_cap(Bb)
    return (formats.coo_to_bell(coo, Bb, f_tile_cap=cap),
            formats.coo_to_bell(coo_t, Bb, f_tile_cap=cap))


def _cost_not_ported(sub, feat_dim, dtype, hw) -> float:
    raise NotImplementedError(
        "cost-model selection is not ported yet: ROADMAP slice A item 6")


REGISTRY.register(KernelSpec(
    name="block_diag",
    kinds=frozenset({DIAG}),
    build=lambda coo, coo_t, B, stats: formats.coo_to_blockdiag(coo, B),
    matvec=lambda bd, x: ops.block_diag_matvec(bd.blocks, x),
    matvec_acc=lambda bd, x, y: ops.block_diag_matvec_acc(bd.blocks, x, y),
    cost=_cost_not_ported,
    doc="dense (B,B) diagonal blocks (paper's dense kernel); CUDA kernel",
))

REGISTRY.register(KernelSpec(
    name="bell",
    kinds=frozenset({OFFDIAG}),
    build=_bell_build,
    matvec=lambda p, x: ops.bell_matvec(p[0], p[1], x),
    matvec_acc=lambda p, x, y: ops.bell_matvec_acc(p[0], p[1], x, y),
    cost=_cost_not_ported,
    needs_transpose=True,
    doc="blocked-ELL over per-bucket (B,B) tiles; CUDA kernel; transpose "
        "materialized for the backward pass",
))

REGISTRY.register(KernelSpec(
    name="ell",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=lambda coo, coo_t, B, stats: formats.coo_to_ell(coo),
    matvec=ops.ell_matvec,
    cost=_cost_not_ported,
    doc="padded-neighbor gather (vertex-parallel CSR analogue)",
))

REGISTRY.register(KernelSpec(
    name="coo",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=lambda coo, coo_t, B, stats: coo,
    matvec=ops.coo_matvec,
    cost=_cost_not_ported,
    doc="edge-parallel scatter-add (index_add_)",
))

REGISTRY.register(KernelSpec(
    name="block_diag_fused",
    kinds=frozenset({DIAG}),
    build=None,
    payload_of="block_diag",
    matvec=None,
    fused_matvec=lambda bd, x, w: ops.block_diag_fused_matvec(bd.blocks, x, w),
    fused_matvec_acc=lambda bd, x, w, y:
        ops.block_diag_fused_matvec_acc(bd.blocks, x, w, y),
    cost=_cost_not_ported,
    doc="fused A @ (X W) over the diagonal blocks, H formed on chip only; "
        "CUDA kernel",
))

REGISTRY.register(KernelSpec(
    name="bell_fused",
    kinds=frozenset({OFFDIAG}),
    build=None,
    payload_of="bell",
    matvec=None,
    fused_matvec=lambda p, x, w: ops.bell_fused_matvec(p[0], p[1], x, w),
    fused_matvec_acc=lambda p, x, w, y:
        ops.bell_fused_matvec_acc(p[0], p[1], x, w, y),
    cost=_cost_not_ported,
    doc="fused blocked-ELL A @ (X W); each stored block transforms its "
        "gathered rows again (recompute traded for the H round trip); "
        "CUDA kernel",
))
