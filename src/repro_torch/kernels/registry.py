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
  fused_dual_matvec(_acc) -- optional dual-weight (SAGE) hooks
                ``(payload, x, w, w_self[, y_in]) ->
                x @ w_self + A @ (x @ w) [+ y_in]``; only the diagonal
                tier's ``block_diag_fused`` has them, and they are no
                probe candidate
  cost       -- analytic roofline seconds for the cost-model selector:
                ``cost(sub, feat_dim, dtype, hw)``; ``feat_dim`` is the
                aggregated width, or the ``(in_dim, out_dim)`` pair for a
                fused spec.  ``hw`` is a ``core.selector.HwModel``.

Registration order is the reference's, and it matters: ``candidates()``
keeps it and both selectors take the first minimum, so it breaks ties.
Registered here: ``block_diag`` and ``bell`` (hand CUDA kernels), ``ell``
and ``coo`` (plain PyTorch gather / ``index_add_``), and the fused
``block_diag_fused`` and ``bell_fused`` (hand CUDA kernels over the
``block_diag`` and ``bell`` payloads); then, one file each as in the
reference, ``csr``/``csr_fused`` (kernels/csr.py), ``sell_cs``/
``sell_fused`` (kernels/sell_cs.py) and ``tcgnn_tile``/
``tcgnn_tile_fused`` (kernels/tcgnn_tile.py, hand CUDA kernels).

The cost formulae are the reference's, term for term, so that both
packages rank candidates alike under one ``HwModel``; they keep its TPU
tiling terms (``_lane_pad``, the VMEM feature-tile caps) for that reason.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

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
    fused_dual_matvec: Callable[..., Any] | None = None
    fused_dual_matvec_acc: Callable[..., Any] | None = None
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

    def candidates(self, kind: str, include_fused: bool = False
                   ) -> tuple[KernelSpec, ...]:
        """Specs applicable to a subgraph kind, in registration order.
        Fused specs need the weight at dispatch, so only transform-first
        callers (GCN) ask for them."""
        return tuple(s for s in self._specs.values()
                     if s.applies_to(kind) and (include_fused or not s.fused))

    def candidates_for(self, sub, include_fused: bool = False
                       ) -> tuple[KernelSpec, ...]:
        """Specs whose payload is materialized on subgraph ``sub``."""
        return tuple(s for s in self.candidates(sub.kind, include_fused)
                     if s.payload_key in sub.formats)



REGISTRY = KernelRegistry()


LANE = 128


def payload_nbytes(payload) -> int:
    """Bytes of a format payload: every array it holds (a container's
    array fields, or each container of a tuple such as ``(bell,
    bell_t)``), numpy or torch, as the reference counts a payload's
    leaves."""
    if isinstance(payload, tuple):
        return sum(payload_nbytes(p) for p in payload)
    total = 0
    for name in formats.ARRAY_FIELDS[type(payload)]:
        a = getattr(payload, name)
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif a is not None:
            total += np.asarray(a).nbytes
    return total


def _bytes_el(dtype) -> int:
    """Bytes per element of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _lane_pad(F: int) -> int:
    """The reference's 128-lane feature padding (its cost terms count it)."""
    return ((F + LANE - 1) // LANE) * LANE


def _f_tile(F: int, cap: int = 512) -> int:
    """The reference's feature tile (``repro/kernels/ops.py`` ``_f_tile``):
    the largest lane multiple <= cap dividing the lane-padded F.  Only the
    cost terms read it."""
    Fp = _lane_pad(F)
    hi = min(max(cap, LANE), Fp)
    best = LANE
    for t in range(LANE, hi + 1, LANE):
        if Fp % t == 0:
            best = t
    return best


def _fused_f_cap(block_size: int, fin_padded: int, stripes: int = 1) -> int:
    """The reference's fused output-tile cap (``repro/kernels/ops.py``
    ``_fused_f_cap``, a TPU VMEM budget): only its cost terms read it."""
    budget_floats = (4 << 20) // 4 // 2
    cap = (budget_floats - block_size * block_size - block_size * fin_padded
           ) // (stripes * fin_padded + 2 * block_size)
    return int(max(LANE, min(1024, (cap // LANE) * LANE)))


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


# ---------------------------------------------------------------------------
# Cost formulae: the reference's two-term roofline estimates
# ---------------------------------------------------------------------------

def _block_diag_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    B = sub.block_size
    nb = sub.n_rows // B
    flops = 2.0 * nb * B * B * feat_dim
    bytes_ = nb * B * B * be + 2.0 * sub.n_rows * feat_dim * be
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    return t + hw.launch_overhead_s


# The reference's blocked-ELL and tcgnn costs add a spill term for the
# budget-capped mini-batch payloads (``_bell_spill_cost``); it comes with
# those payloads (ROADMAP slice C).

def _bell_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    bl = sub.formats["bell"][0]
    B = bl.block_size
    nblk = bl.n_brow * bl.max_blocks       # every slot, padding included
    flops = 2.0 * nblk * B * B * feat_dim
    bytes_ = nblk * (B * B * be + B * feat_dim * be) + sub.n_rows * feat_dim * be
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    return t + hw.launch_overhead_s


def _ell_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    n = sub.n_rows
    K = sub.formats["ell"].max_deg
    flops = 2.0 * n * K * feat_dim
    bytes_ = n * K * (feat_dim * be + 4) + n * feat_dim * be
    return max(flops / hw.peak_flops,
               bytes_ / (hw.hbm_bw * hw.gather_eff)) + hw.launch_overhead_s


def _coo_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    nnz = sub.stats["nnz"]
    flops = 2.0 * nnz * feat_dim
    bytes_ = nnz * (2 * feat_dim * be + 8) + sub.n_rows * feat_dim * be
    return max(flops / hw.peak_flops,
               bytes_ / (hw.hbm_bw * hw.scatter_eff)) + hw.launch_overhead_s


def _block_diag_fused_cost(sub, feat_dims, dtype, hw) -> float:
    fin, fout = feat_dims
    be = _bytes_el(dtype)
    B = sub.block_size
    nb = sub.n_rows // B
    ft = min(_fused_f_cap(B, _lane_pad(fin)), _lane_pad(fout))
    njt = max(1, -(-_lane_pad(fout) // ft))
    flops = 2.0 * nb * B * (fin * fout + B * fout)
    bytes_ = (nb * B * B * be                     # adjacency blocks
              + sub.n_rows * fin * be * njt      # x re-read per output tile
              + nb * fin * fout * be             # weight stripe per block
              + sub.n_rows * fout * be)          # output
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    return t + hw.launch_overhead_s


def _bell_fused_cost(sub, feat_dims, dtype, hw) -> float:
    fin, fout = feat_dims
    be = _bytes_el(dtype)
    bl = sub.formats["bell"][0]
    B = bl.block_size
    nblk = bl.n_brow * bl.max_blocks
    ft = min(bl.f_tile_cap, _fused_f_cap(B, _lane_pad(fin)), _lane_pad(fout))
    njt = max(1, -(-_lane_pad(fout) // ft))
    # the transform re-runs per stored block (recompute for the H trip)
    flops = 2.0 * nblk * B * (fin * fout + B * fout)
    bytes_ = (nblk * B * B * be
              + nblk * B * fin * be * njt        # gathered x per stored block
              + nblk * fin * fout * be           # weight stripe per step
              + sub.n_rows * fout * be)
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    return t + hw.launch_overhead_s


REGISTRY.register(KernelSpec(
    name="block_diag",
    kinds=frozenset({DIAG}),
    build=lambda coo, coo_t, B, stats: formats.coo_to_blockdiag(coo, B),
    matvec=lambda bd, x: ops.block_diag_matvec(bd.blocks, x),
    matvec_acc=lambda bd, x, y: ops.block_diag_matvec_acc(bd.blocks, x, y),
    cost=_block_diag_cost,
    doc="dense (B,B) diagonal blocks (paper's dense kernel); CUDA kernel",
))

REGISTRY.register(KernelSpec(
    name="bell",
    kinds=frozenset({OFFDIAG}),
    build=_bell_build,
    matvec=lambda p, x: ops.bell_matvec(p[0], p[1], x),
    matvec_acc=lambda p, x, y: ops.bell_matvec_acc(p[0], p[1], x, y),
    cost=_bell_cost,
    needs_transpose=True,
    doc="blocked-ELL over per-bucket (B,B) tiles; CUDA kernel; transpose "
        "materialized for the backward pass",
))

REGISTRY.register(KernelSpec(
    name="ell",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=lambda coo, coo_t, B, stats: formats.coo_to_ell(coo),
    matvec=ops.ell_matvec,
    cost=_ell_cost,
    doc="padded-neighbor gather (vertex-parallel CSR analogue)",
))

REGISTRY.register(KernelSpec(
    name="coo",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=lambda coo, coo_t, B, stats: coo,
    matvec=ops.coo_matvec,
    cost=_coo_cost,
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
    fused_dual_matvec=lambda bd, x, w, ws:
        ops.block_diag_dual_matvec(bd.blocks, x, w, ws),
    fused_dual_matvec_acc=lambda bd, x, w, ws, y:
        ops.block_diag_dual_matvec_acc(bd.blocks, x, w, ws, y),
    cost=_block_diag_fused_cost,
    doc="fused A @ (X W) over the diagonal blocks, H formed on chip only; "
        "CUDA kernel; the dual-weight hook adds SAGE's self term X W_self "
        "from the same on-chip rows of X",
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
    cost=_bell_fused_cost,
    doc="fused blocked-ELL A @ (X W); each stored block transforms its "
        "gathered rows again (recompute traded for the H round trip); "
        "CUDA kernel",
))

# one-file kernel registrations, in the reference's order (importing each
# module registers its specs)
from repro_torch.kernels import csr  # noqa: E402,F401
from repro_torch.kernels import sell_cs  # noqa: E402,F401
from repro_torch.kernels import tcgnn_tile  # noqa: E402,F401
