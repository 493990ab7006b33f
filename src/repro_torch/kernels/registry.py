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
    # build consumes coo_t: a bool, or a function of the tier stats (the
    # budget-capped builds derive their transpose from the stored edges)
    needs_transpose: Any = False    # bool | Callable[[dict], bool]
    matvec_acc: Callable[[Any, Any, Any], Any] | None = None
    fused_matvec: Callable[..., Any] | None = None
    fused_matvec_acc: Callable[..., Any] | None = None
    fused_dual_matvec: Callable[..., Any] | None = None
    fused_dual_matvec_acc: Callable[..., Any] | None = None
    payload_of: str | None = None   # alias another kernel's format payload
    doc: str = ""

    def wants_transpose(self, stats: dict | None) -> bool:
        if callable(self.needs_transpose):
            return bool(self.needs_transpose(stats or {}))
        return bool(self.needs_transpose)

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
    """Blocked-ELL payload.  With ``stats["edge_budget"]`` (the mini-batch
    path) it is the budget-padded triple ``(bell, bell_t, spill)``
    (:func:`_bell_build_capped`); otherwise the full-batch pair ``(bell,
    bell_t)`` with the data-dependent per-bucket block size and K."""
    budget = (stats or {}).get("edge_budget")
    if budget:
        return _bell_build_capped(coo, block_size, int(budget),
                                  slack=(stats or {}).get("bell_slack"))
    Bb = _bell_pick_block(coo, block_size)
    cap = _bell_f_cap(Bb)
    return (formats.coo_to_bell(coo, Bb, f_tile_cap=cap),
            formats.coo_to_bell(coo_t, Bb, f_tile_cap=cap))


def _np_edges(coo):
    return (formats._np(coo.rows), formats._np(coo.cols),
            formats._np(coo.vals))


def _bell_build_capped(coo, block_size, edge_budget, slack=None):
    """Budget-padded blocked-ELL payload ``(bell, bell_t, spill)``.

    The block size is the community size and K is
    :func:`formats.bell_budget_k` of the edge budget (``slack``, the
    PlanCache's adapted factor, overrides its default), so every batch's
    payload has one shape.  The forward cap keeps each block row's densest
    blocks; the transpose of the stored edges is capped again, and the
    forward payload is rebuilt from the edges that survive both, so
    ``bell_t`` is exactly the transpose of ``bell``: the blocked-ELL
    backward passes stay right as they are.  Every edge either cap
    rejected goes to the spill COO, which aggregates through torch ops in
    both directions."""
    K = formats.bell_budget_k(edge_budget, coo.n_rows, block_size,
                              **({} if slack is None else dict(slack=slack)))
    cap = _bell_f_cap(block_size)
    _, spill_fwd, stored = formats.coo_to_bell_capped(
        coo, block_size, K, f_tile_cap=cap, build_blocks=False)
    sr, sc, sv = _np_edges(stored)
    coo_st = formats.coo_from_edges(stored.n_cols, stored.n_rows, sc, sr, sv)
    bell_t, spill_t, stored_t = formats.coo_to_bell_capped(
        coo_st, block_size, K, f_tile_cap=cap)
    tr, tc, tv = _np_edges(stored_t)
    bell, leftover, _ = formats.coo_to_bell_capped(
        formats.coo_from_edges(coo.n_rows, coo.n_cols, tc, tr, tv),
        block_size, K, f_tile_cap=cap)
    if leftover.nnz:    # a subset of a K-fitting edge set fits K
        raise RuntimeError("capped blocked-ELL rebuild spilled edges")
    fr, fc, fv = _np_edges(spill_fwd)
    xr, xc, xv = _np_edges(spill_t)      # transpose orientation: swap back
    spill = formats.coo_from_edges(
        coo.n_rows, coo.n_cols, np.concatenate([fr, xc]),
        np.concatenate([fc, xr]), np.concatenate([fv, xv]))
    return (bell, bell_t, spill)


# Dispatch shims over both blocked-ELL payloads: the full-batch (bell,
# bell_t) pair and the budget-padded (bell, bell_t, spill) triple.  Only
# the pair goes through the kernels' autograd Functions; the spill is
# plain torch ops (index_add_, or the per-edge transform when fused), so
# autograd differentiates it once, beside them.

def _bell_mv(p, x):
    y = ops.bell_matvec(p[0], p[1], x)
    return y + ops.coo_matvec(p[2], x) if len(p) > 2 else y


def _bell_mv_acc(p, x, y_in):
    y = ops.bell_matvec_acc(p[0], p[1], x, y_in)
    return y + ops.coo_matvec(p[2], x) if len(p) > 2 else y


def _bell_fmv(p, x, w):
    y = ops.bell_fused_matvec(p[0], p[1], x, w)
    return y + ops.coo_transform_matvec(p[2], x, w) if len(p) > 2 else y


def _bell_fmv_acc(p, x, w, y_in):
    y = ops.bell_fused_matvec_acc(p[0], p[1], x, w, y_in)
    return y + ops.coo_transform_matvec(p[2], x, w) if len(p) > 2 else y


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


def _bell_spill_cost(nnz, n_rows, feat_dim, dtype, hw) -> float:
    """Scatter-class seconds of a capped payload's spilled edges (the COO
    term's shape, no launch of its own), priced at the real spill nnz."""
    be = _bytes_el(dtype)
    flops = 2.0 * nnz * feat_dim
    bytes_ = nnz * (2 * feat_dim * be + 8) + n_rows * feat_dim * be
    return max(flops / hw.peak_flops, bytes_ / (hw.hbm_bw * hw.scatter_eff))


def _bell_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    p = sub.formats["bell"]
    bl = p[0]
    B = bl.block_size
    nblk = bl.n_brow * bl.max_blocks       # every slot, padding included
    flops = 2.0 * nblk * B * B * feat_dim
    bytes_ = nblk * (B * B * be + B * feat_dim * be) + sub.n_rows * feat_dim * be
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    if len(p) > 2 and p[2].nnz:          # budget-capped: the spill's term
        t += _bell_spill_cost(p[2].nnz, sub.n_rows, feat_dim, dtype, hw)
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
    p = sub.formats["bell"]
    bl = p[0]
    B = bl.block_size
    nblk = bl.n_brow * bl.max_blocks     # includes budget-cap padding
    ft = min(bl.f_tile_cap, _fused_f_cap(B, _lane_pad(fin)), _lane_pad(fout))
    njt = max(1, -(-_lane_pad(fout) // ft))
    # the transform re-runs per stored block (recompute for the H trip)
    flops = 2.0 * nblk * B * (fin * fout + B * fout)
    bytes_ = (nblk * B * B * be
              + nblk * B * fin * be * njt        # gathered x per stored block
              + nblk * fin * fout * be           # weight stripe per step
              + sub.n_rows * fout * be)
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    if len(p) > 2 and p[2].nnz:
        # spilled edges transform their gathered source rows one by one
        # (coo_transform_matvec)
        E = p[2].nnz
        flops_s = 2.0 * E * (fin * fout + fout)
        bytes_s = (E * (fin * be + fout * be + 8)
                   + sub.n_rows * fout * be)
        t += max(flops_s / hw.peak_flops,
                 bytes_s / (hw.hbm_bw * hw.scatter_eff))
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
    matvec=_bell_mv,
    matvec_acc=_bell_mv_acc,
    cost=_bell_cost,
    # the full-batch build reads coo_t; the capped one derives its own
    needs_transpose=lambda stats: not stats.get("edge_budget"),
    doc="blocked-ELL over per-bucket (B,B) tiles; CUDA kernel; transpose "
        "materialized for the backward pass; budget-capped K and a COO "
        "spill under an edge budget",
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
    fused_matvec=_bell_fmv,
    fused_matvec_acc=_bell_fmv_acc,
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
