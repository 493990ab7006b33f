"""TC-GNN-style column-condensed tiles: the ``tcgnn_tile`` and
``tcgnn_tile_fused`` registry entries, their CUDA kernels' wrappers and
their gradients.

Counterpart of ``repro/kernels/tcgnn_tile.py`` (TC-GNN, Wang et al.).  Per
block row the builder ranks the distinct source columns densest first,
packs their edge values into a dense (B, C) tile (``tiles[i, r, s]`` is the
weight of edge ``(i*B + r, gather_idx[i, s])``) and keeps the column ids
in ``gather_idx``; slots past a row's real column count hold zeros and
point at row 0.  C is the reference's lane-rounded count (a multiple of
128), kept so the payload is byte-identical.

The three Pallas TPU kernels of the reference (``tcgnn_spmm``,
``tcgnn_spmm_fused``, ``tcgnn_spmm_dw``) are hand CUDA kernels here
(``csrc/tcgnn_spmm*.cu``, design and bound in their headers).  Each takes
the payload and x and gathers the rows of x itself, so the reference's
(nbr, C, F) gather ``x[gather_idx]`` is never written.  On CPU tensors the
wrappers run the plain versions in ``kernels/ref.py``; a CUDA input
launches the kernel or raises.

The ``torch.autograd.Function``s mirror the reference's four custom VJPs:
dX = A^T dY is the same kernel over the transpose payload ``tc_t``; the
fused form's dX = A^T (dY W^T) is the fused kernel over ``tc_t`` with W^T,
and dW = X^T (A^T dY) is the ``tcgnn_spmm_dw`` reduction.  dX is computed
only when autograd asks for it.

Under the mini-batch edge budget the payload is the budget-capped triple
``(tc, tc_t, spill)``: C is :func:`tcgnn_budget_c` of the budget alone,
each block row keeps its densest C columns, and the overflow goes to a
COO spill that torch ops aggregate (``index_add_``, or the per-edge
transform when fused) beside the kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.registry import (LANE, OFFDIAG, REGISTRY,
                                          KernelSpec, _bell_spill_cost,
                                          _bytes_el, _f_tile, _lane_pad,
                                          _np_edges)

C_TILE_CAP = 512     # the reference's condensed-column tile (cost terms)

plain = ref.tcgnn_spmm
plain_fused = ref.tcgnn_spmm_fused
plain_dw = ref.tcgnn_spmm_dw
launches = _build.LaunchCount()
fused_launches = _build.LaunchCount()
dw_launches = _build.LaunchCount()

# block rows per partial sum of tcgnn_spmm_dw: fixed, so the order of the
# reduction (and the result's bits) does not depend on the card.  Tuned to
# pubmed: at 10, its 1233 transpose block rows make 124 CTAs, one wave over
# an H100's 132 SMs (4, 8 and 16 were slower).  Phase a of
# csrc/tcgnn_spmm_dw.cu gives each of a split's rows its own warp only up to
# 16 rows; another value must be measured again
DW_ROWS_PER_SPLIT = 10


@dataclass(frozen=True)
class TcgnnTile:
    """Column-condensed dense tiles and their per-block-row gather index."""
    n_rows: int
    n_cols: int
    block_size: int
    n_cond: int                # C, a multiple of 128
    f_tile_cap: int = 512      # the reference's TPU feature-tile cap
    budgeted: bool = False
    tiles: Any = None          # (n_brow, B, C) float32 condensed adjacency
    gather_idx: Any = None     # (n_brow, C) int32 source ids, 0 where padded

    @property
    def n_brow(self) -> int:
        return self.n_rows // self.block_size


formats.ARRAY_FIELDS[TcgnnTile] = ("tiles", "gather_idx")


# ---------------------------------------------------------------------------
# Host-side builders (numpy, byte-identical to the reference's)
# ---------------------------------------------------------------------------

def _cond_rank(rows: np.ndarray, cols: np.ndarray, n_cols: int,
               block_size: int):
    """Rank each block row's distinct source columns densest first (ties
    toward the lower column id)."""
    brow = (rows // block_size).astype(np.int64)
    key = brow * np.int64(n_cols) + cols.astype(np.int64)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    ubrow, ucol = uniq // n_cols, uniq % n_cols
    order = np.lexsort((ucol, -counts, ubrow))
    sorted_brow = ubrow[order]
    rank_sorted = (np.arange(len(uniq))
                   - np.searchsorted(sorted_brow, sorted_brow))
    slot = np.empty(len(uniq), np.int64)
    slot[order] = rank_sorted
    return brow, ubrow, ucol, slot, slot[inv]


def coo_to_tcgnn(coo: formats.COO, block_size: int,
                 f_tile_cap: int = 512) -> TcgnnTile:
    """Full-batch condensation: C is the largest distinct-column count of
    any block row, rounded up to a multiple of 128."""
    B = block_size
    n_rpad = ((coo.n_rows + B - 1) // B) * B
    nbr = max(n_rpad // B, 1)
    rows, cols, vals = (formats._np(coo.rows), formats._np(coo.cols),
                        formats._np(coo.vals))
    if len(rows):
        brow, ubrow, ucol, slot, edge_slot = _cond_rank(
            rows, cols, coo.n_cols, B)
        C = _lane_pad(int(slot.max()) + 1)
    else:
        C = LANE
    tiles = np.zeros((nbr, B, C), np.float32)
    gather_idx = np.zeros((nbr, C), np.int32)
    if len(rows):
        gather_idx[ubrow, slot] = ucol
        tiles[brow, rows % B, edge_slot] = vals
    return TcgnnTile(n_rpad, coo.n_cols, B, C, f_tile_cap, tiles=tiles,
                     gather_idx=gather_idx)


def _tcgnn_f_cap(block_size: int) -> int:
    """The reference's feature-tile cap (a TPU VMEM budget).  The CUDA
    kernels do not read it; it rides along as part of the payload."""
    budget_floats = (4 << 20) // 4 // 2
    cap = ((budget_floats - block_size * C_TILE_CAP)
           // (C_TILE_CAP + 2 * block_size))
    return int(max(LANE, min(1024, (cap // LANE) * LANE)))


def tcgnn_budget_c(edge_budget: int, n_pad: int, block_size: int,
                   slack: float = 2.0) -> int:
    """Condensed-column cap C of the budget-capped payload: a function of
    the edge budget alone, so every batch has one (n_brow, B, C) shape.
    C covers ``slack`` times the per-block-row average edge count (each
    stored edge its own column at worst), rounded up to a multiple of 128
    and bounded by the 128-rounded column count."""
    nbr = max(n_pad // block_size, 1)
    c = -(-int(slack * edge_budget) // nbr)
    c = -(-max(c, 1) // LANE) * LANE
    return int(max(LANE, min(c, _lane_pad(n_pad))))


def coo_to_tcgnn_capped(coo: formats.COO, block_size: int, c_max: int,
                        f_tile_cap: int = 512, build_tiles: bool = True
                        ) -> tuple[TcgnnTile | None, formats.COO,
                                   formats.COO]:
    """Condensed tiles with exactly ``c_max`` (rounded up to a multiple of
    128) column slots per block row.  Rows with more distinct columns keep
    their densest (ties toward the lower column id); the other edges come
    back as a row-sorted spill COO and the stored ones as a third COO.
    Returns ``(tc, spill, stored)`` with ``tc.budgeted=True``;
    ``build_tiles=False`` skips the (n_brow, B, C) scatter (``tc=None``)."""
    B = block_size
    n_rpad = ((coo.n_rows + B - 1) // B) * B
    nbr = max(n_rpad // B, 1)
    C = int(max(LANE, -(-int(c_max) // LANE) * LANE))
    rows, cols, vals = _np_edges(coo)
    if build_tiles:
        tiles = np.zeros((nbr, B, C), np.float32)
        gather_idx = np.zeros((nbr, C), np.int32)
    if len(rows):
        brow, ubrow, ucol, slot, edge_slot = _cond_rank(
            rows, cols, coo.n_cols, B)
        stored_m = edge_slot < C
        if build_tiles:
            sb = np.flatnonzero(slot < C)
            gather_idx[ubrow[sb], slot[sb]] = ucol[sb]
            tiles[brow[stored_m], rows[stored_m] % B,
                  edge_slot[stored_m]] = vals[stored_m]
    else:
        stored_m = np.zeros(0, bool)
    tc = (TcgnnTile(n_rpad, coo.n_cols, B, C, f_tile_cap, budgeted=True,
                    tiles=tiles, gather_idx=gather_idx)
          if build_tiles else None)
    spill = formats.coo_from_edges(n_rpad, coo.n_cols, rows[~stored_m],
                                   cols[~stored_m], vals[~stored_m])
    stored = formats.coo_from_edges(n_rpad, coo.n_cols, rows[stored_m],
                                    cols[stored_m], vals[stored_m])
    return tc, spill, stored


def _tcgnn_build(coo, coo_t, block_size, stats):
    """Condensed-tile payload.  With ``stats["edge_budget"]`` (the
    mini-batch path) it is the budget-capped triple ``(tc, tc_t, spill)``
    (:func:`_tcgnn_build_capped`, its slack shared with blocked-ELL's,
    ``stats["bell_slack"]``); otherwise the full-batch pair ``(tc, tc_t)``,
    whose transpose the backward passes run over."""
    budget = (stats or {}).get("edge_budget")
    if budget:
        return _tcgnn_build_capped(coo, block_size, int(budget),
                                   slack=(stats or {}).get("bell_slack"))
    cap = _tcgnn_f_cap(block_size)
    return (coo_to_tcgnn(coo, block_size, f_tile_cap=cap),
            coo_to_tcgnn(coo_t, block_size, f_tile_cap=cap))


def _tcgnn_build_capped(coo, block_size, edge_budget, slack=None):
    """Budget-capped payload ``(tc, tc_t, spill)``, built as the capped
    blocked-ELL is at column granularity: cap the forward edges, cap the
    transpose of the stored ones, rebuild the forward payload from the
    survivors (it never spills), so ``tc_t`` is exactly ``tc``
    transposed; every rejected edge goes to the spill."""
    C = tcgnn_budget_c(edge_budget, coo.n_rows, block_size,
                       **({} if slack is None else dict(slack=slack)))
    cap = _tcgnn_f_cap(block_size)
    _, spill_fwd, stored = coo_to_tcgnn_capped(
        coo, block_size, C, build_tiles=False)
    sr, sc, sv = _np_edges(stored)
    coo_st = formats.coo_from_edges(stored.n_cols, stored.n_rows, sc, sr, sv)
    tc_t, spill_t, stored_t = coo_to_tcgnn_capped(
        coo_st, block_size, C, f_tile_cap=cap)
    tr, tcc, tv = _np_edges(stored_t)
    tc, leftover, _ = coo_to_tcgnn_capped(
        formats.coo_from_edges(coo.n_rows, coo.n_cols, tcc, tr, tv),
        block_size, C, f_tile_cap=cap)
    if leftover.nnz:    # a subset of a C-fitting column set fits C
        raise RuntimeError("capped tcgnn_tile rebuild spilled edges")
    fr, fc, fv = _np_edges(spill_fwd)
    xr, xc, xv = _np_edges(spill_t)      # transpose orientation: swap back
    spill = formats.coo_from_edges(
        coo.n_rows, coo.n_cols, np.concatenate([fr, xc]),
        np.concatenate([fc, xr]), np.concatenate([fv, xv]))
    return (tc, tc_t, spill)


def real_slots(tiles: torch.Tensor) -> torch.Tensor:
    """Per block row, one past the last slot whose tile column holds a
    non-zero in any of the B rows: the slots the CUDA kernel
    ``tcgnn_spmm_fused`` gathers and transforms (the rest add nothing).
    tiles: (nbr, B, C) -> (nbr,) int64."""
    nz = (tiles != 0).any(dim=1)
    pos = torch.arange(1, tiles.shape[-1] + 1, device=tiles.device)
    return (nz * pos).amax(dim=1) if tiles.shape[0] else pos[:0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(tiles, gather_idx, x, y_in, fo: int, *floats) -> None:
    """Shapes, and one device and one dtype for x, y_in and ``floats``."""
    if tiles.dim() != 3:
        raise ValueError(f"tiles must be (nbr, B, C), got {tuple(tiles.shape)}")
    nbr, B, C = tiles.shape
    if tuple(gather_idx.shape) != (nbr, C):
        raise ValueError(f"gather_idx must be {(nbr, C)}, "
                         f"got {tuple(gather_idx.shape)}")
    if x.dim() != 2:
        raise ValueError(f"x must be (n_cols, F), got {tuple(x.shape)}")
    if y_in is not None and tuple(y_in.shape) != (nbr * B, fo):
        raise ValueError(f"y_in must be {(nbr * B, fo)}, "
                         f"got {tuple(y_in.shape)}")
    # tiles are float32 whatever x's dtype, so they join the device check
    # only
    _build.check_operands((x, y_in, *floats), (gather_idx, tiles))


def _cuda_code(tiles, gather_idx, x, *floats) -> int:
    """The kernels' dtype code, after the CUDA operand checks; tiles must
    be contiguous float32."""
    code = _build.cuda_dtype_code((x, *floats), (gather_idx,),
                                  block_size=tiles.shape[1])
    if tiles.dtype != torch.float32 or not tiles.is_contiguous():
        raise ValueError("CUDA kernel takes contiguous float32 tiles, got "
                         f"{tiles.dtype}")
    return code


def tcgnn_spmm(tiles: torch.Tensor, gather_idx: torch.Tensor,
               x: torch.Tensor, y_in: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Y = A_tc @ x (+ y_in), float32 accumulation.  Returns (nbr*B, F).

    tiles: (nbr, B, C); gather_idx: (nbr, C) int32 rows of x; x: (n_cols,
    F); y_in: optional (nbr*B, F).  CUDA tensors must be contiguous, x and
    y_in float32 or bfloat16, tiles float32, B <= 64."""
    _check(tiles, gather_idx, x, y_in, x.shape[-1])
    if x.device.type == "cpu":
        return plain(tiles, gather_idx, x, y_in)
    code = _cuda_code(tiles, gather_idx, x, y_in)
    nbr, B, C = tiles.shape
    y = torch.empty((nbr * B, x.shape[1]), dtype=x.dtype, device=x.device)
    lib = _build.library("tcgnn_spmm")
    with torch.cuda.device(x.device):
        lib.launch(tiles.data_ptr(), gather_idx.data_ptr(), x.data_ptr(),
                   _build.ptr(y_in), y.data_ptr(), nbr, B, C, x.shape[1],
                   code, _build.stream(x))
    launches.add()
    return y


def tcgnn_spmm_fused(tiles: torch.Tensor, gather_idx: torch.Tensor,
                     x: torch.Tensor, w: torch.Tensor,
                     y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A_tc @ (x @ w) (+ y_in), float32 accumulation, each condensed
    slot's gathered row of x transformed on chip.  Returns (nbr*B, Fo).

    x: (n_cols, Fi); w: (Fi, Fo); y_in: optional (nbr*B, Fo); the rest as
    in :func:`tcgnn_spmm`."""
    if w.dim() != 2 or x.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be ({x.shape[-1]}, Fo), "
                         f"got {tuple(w.shape)}")
    _check(tiles, gather_idx, x, y_in, w.shape[1], w)
    if x.device.type == "cpu":
        return plain_fused(tiles, gather_idx, x, w, y_in)
    code = _cuda_code(tiles, gather_idx, x, w, y_in)
    nbr, B, C = tiles.shape
    Fi, Fo = w.shape
    y = torch.empty((nbr * B, Fo), dtype=x.dtype, device=x.device)
    lib = _build.library("tcgnn_spmm_fused")
    with torch.cuda.device(x.device):
        lib.launch(tiles.data_ptr(), gather_idx.data_ptr(), x.data_ptr(),
                   w.data_ptr(), _build.ptr(y_in), y.data_ptr(), nbr, B, C,
                   Fi, Fo, code, _build.stream(x))
    fused_launches.add()
    return y


def dw_splits(nbr: int) -> int:
    """Partial sums of tcgnn_spmm_dw over ``nbr`` block rows: split s owns
    rows [s * DW_ROWS_PER_SPLIT, (s + 1) * DW_ROWS_PER_SPLIT), the last one
    the rest."""
    return -(-nbr // DW_ROWS_PER_SPLIT)


def tcgnn_spmm_dw(tiles_t: torch.Tensor, gather_idx_t: torch.Tensor,
                  x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW = x^T @ (A^T @ g), A^T given as the condensed transpose payload.
    Returns (Fi, Fo) float32 (float64 for float64 CPU inputs).

    tiles_t: (nbr, B, C); gather_idx_t: (nbr, C) int32 rows of g;
    x: (nbr*B, Fi); g: (n_cols, Fo).  On CUDA the block rows are summed in
    a fixed order, without atomics, so every run gives the same bits."""
    nbr, B, C = tiles_t.shape
    if x.dim() != 2 or x.shape[0] != nbr * B:
        raise ValueError(f"x must be ({nbr * B}, Fi), got {tuple(x.shape)}")
    _check(tiles_t, gather_idx_t, g, None, g.shape[-1], x)
    if x.device.type == "cpu":
        return plain_dw(tiles_t, gather_idx_t, x, g)
    code = _cuda_code(tiles_t, gather_idx_t, x, g)
    Fi, Fo = x.shape[1], g.shape[1]
    partial = torch.empty((dw_splits(nbr), Fi, Fo), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((Fi, Fo), dtype=torch.float32, device=x.device)
    lib = _build.library("tcgnn_spmm_dw")
    with torch.cuda.device(x.device):
        lib.launch(tiles_t.data_ptr(), gather_idx_t.data_ptr(), x.data_ptr(),
                   g.data_ptr(), partial.data_ptr(), dw.data_ptr(), nbr, B, C,
                   Fi, Fo, DW_ROWS_PER_SPLIT, code, _build.stream(x))
    dw_launches.add()
    return dw


# ---------------------------------------------------------------------------
# Gradients (the reference's custom VJPs)
# ---------------------------------------------------------------------------

class _Tcgnn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tc, tc_t, x, y_in):
        ctx.tc_t, ctx.n_in, ctx.x_dtype = tc_t, x.shape[0], x.dtype
        return tcgnn_spmm(tc.tiles, tc.gather_idx, x.contiguous(), y_in)

    @staticmethod
    def backward(ctx, dy):
        dx = None
        if ctx.needs_input_grad[2]:                 # A^T dY over tc_t
            tc_t = ctx.tc_t
            dx = tcgnn_spmm(tc_t.tiles, tc_t.gather_idx, dy.contiguous())
            dx = dx[: ctx.n_in].to(ctx.x_dtype)
        return None, None, dx, dy if ctx.needs_input_grad[3] else None


class _TcgnnFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tc, tc_t, x, w, y_in):
        x, w = x.contiguous(), w.contiguous()
        ctx.tc_t = tc_t
        ctx.save_for_backward(x, w)
        return tcgnn_spmm_fused(tc.tiles, tc.gather_idx, x, w, y_in)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        tc_t = ctx.tc_t
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[2]:                 # A^T (dY W^T), fused
            dx = tcgnn_spmm_fused(tc_t.tiles, tc_t.gather_idx, dy,
                                  w.t().contiguous())
            dx = dx[: x.shape[0]].to(x.dtype)
        if ctx.needs_input_grad[3]:                 # X^T (A^T dY)
            dw = tcgnn_spmm_dw(tc_t.tiles, tc_t.gather_idx, x, dy).to(w.dtype)
        return (None, None, dx, dw,
                dy if ctx.needs_input_grad[4] else None)


def tcgnn_matvec(tc: TcgnnTile, tc_t: TcgnnTile,
                 x: torch.Tensor) -> torch.Tensor:
    """Y = A_tc @ x; ``tc_t`` is the transpose payload of the backward."""
    return _Tcgnn.apply(tc, tc_t, x, None)


def tcgnn_matvec_acc(tc: TcgnnTile, tc_t: TcgnnTile, x: torch.Tensor,
                     y_in: torch.Tensor) -> torch.Tensor:
    """Y = A_tc @ x + y_in (accumulating dispatch mode)."""
    return _Tcgnn.apply(tc, tc_t, x, y_in.contiguous())


def tcgnn_fused_matvec(tc: TcgnnTile, tc_t: TcgnnTile, x: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Y = A_tc @ (x @ w), one fused kernel."""
    return _TcgnnFused.apply(tc, tc_t, x, w, None)


def tcgnn_fused_matvec_acc(tc: TcgnnTile, tc_t: TcgnnTile, x: torch.Tensor,
                           w: torch.Tensor,
                           y_in: torch.Tensor) -> torch.Tensor:
    """Y = A_tc @ (x @ w) + y_in, one fused kernel."""
    return _TcgnnFused.apply(tc, tc_t, x, w, y_in.contiguous())


# Dispatch shims over both payloads: the full-batch (tc, tc_t) pair and
# the budget-capped (tc, tc_t, spill) triple, whose spill is torch ops
# beside the kernels' autograd Functions (as blocked-ELL's is)

def _tc_mv(p, x):
    y = tcgnn_matvec(p[0], p[1], x)
    return y + ops.coo_matvec(p[2], x) if len(p) > 2 else y


def _tc_mv_acc(p, x, y_in):
    y = tcgnn_matvec_acc(p[0], p[1], x, y_in)
    return y + ops.coo_matvec(p[2], x) if len(p) > 2 else y


def _tc_fmv(p, x, w):
    y = tcgnn_fused_matvec(p[0], p[1], x, w)
    return y + ops.coo_transform_matvec(p[2], x, w) if len(p) > 2 else y


def _tc_fmv_acc(p, x, w, y_in):
    y = tcgnn_fused_matvec_acc(p[0], p[1], x, w, y_in)
    return y + ops.coo_transform_matvec(p[2], x, w) if len(p) > 2 else y


# ---------------------------------------------------------------------------
# Cost model (the reference's terms: every one of the n_brow * C slots is
# priced, the XLA gather that feeds its kernel as gather-class traffic)
# ---------------------------------------------------------------------------

def _c_tile_of(C: int) -> int:
    return _f_tile(C, cap=C_TILE_CAP)


def _tc_fused_f_cap(block_size: int, c_tile: int, fin_padded: int) -> int:
    """The reference's fused output-tile cap (a TPU VMEM budget)."""
    budget_floats = (4 << 20) // 4 // 2
    cap = ((budget_floats - block_size * c_tile - c_tile * fin_padded)
           // (fin_padded + 2 * block_size))
    return int(max(LANE, min(1024, (cap // LANE) * LANE)))


def _tcgnn_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    p = sub.formats["tcgnn_tile"]
    tc = p[0]
    B, nbr, C = tc.block_size, tc.n_brow, tc.n_cond
    flops = 2.0 * nbr * B * C * feat_dim
    gather_bytes = nbr * C * feat_dim * be     # (nbr, C, F) stripe volume
    bytes_ = (nbr * B * C * 4                  # condensed tiles (f32)
              + gather_bytes                   # kernel streams the stripes
              + sub.n_rows * feat_dim * be)    # output
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    t += gather_bytes / (hw.hbm_bw * hw.gather_eff)
    if len(p) > 2 and p[2].nnz:                # budget-capped: spill term
        t += _bell_spill_cost(p[2].nnz, sub.n_rows, feat_dim, dtype, hw)
    return t + hw.launch_overhead_s


def _tcgnn_fused_cost(sub, feat_dims, dtype, hw) -> float:
    fin, fout = feat_dims
    be = _bytes_el(dtype)
    p = sub.formats["tcgnn_tile"]
    tc = p[0]
    B, nbr, C = tc.block_size, tc.n_brow, tc.n_cond
    ct = _c_tile_of(C)
    ft = min(tc.f_tile_cap, _tc_fused_f_cap(B, ct, _lane_pad(fin)),
             _lane_pad(fout))
    njt = max(1, -(-_lane_pad(fout) // ft))
    # the transform runs once per condensed slot (C per block row)
    flops = 2.0 * nbr * C * (fin * fout + B * fout)
    gather_bytes = nbr * C * fin * be
    bytes_ = (nbr * B * C * 4
              + gather_bytes * njt             # stripe re-read per out tile
              + nbr * fin * fout * be          # weight stripe per block row
              + sub.n_rows * fout * be)
    t = max(flops / (hw.peak_flops * hw.mxu_eff(B)), bytes_ / hw.hbm_bw)
    t += gather_bytes / (hw.hbm_bw * hw.gather_eff)
    if len(p) > 2 and p[2].nnz:
        # spilled edges transform their gathered source rows one by one
        E = p[2].nnz
        flops_s = 2.0 * E * (fin * fout + fout)
        bytes_s = E * (fin * be + fout * be + 8) + sub.n_rows * fout * be
        t += max(flops_s / hw.peak_flops,
                 bytes_s / (hw.hbm_bw * hw.scatter_eff))
    return t + hw.launch_overhead_s


REGISTRY.register(KernelSpec(
    name="tcgnn_tile",
    kinds=frozenset({OFFDIAG}),
    build=_tcgnn_build,
    matvec=_tc_mv,
    matvec_acc=_tc_mv_acc,
    cost=_tcgnn_cost,
    # the full-batch build reads coo_t; the capped one derives its own
    needs_transpose=lambda stats: not stats.get("edge_budget"),
    doc="TC-GNN-style column condensation: each block row's non-zero "
        "columns packed into dense (B, C) tiles + a gather index; CUDA "
        "kernel that gathers the rows of x itself; budget-capped C and a "
        "COO spill under an edge budget",
))

REGISTRY.register(KernelSpec(
    name="tcgnn_tile_fused",
    kinds=frozenset({OFFDIAG}),
    build=None,
    payload_of="tcgnn_tile",
    matvec=None,
    fused_matvec=_tc_fmv,
    fused_matvec_acc=_tc_fmv_acc,
    cost=_tcgnn_fused_cost,
    doc="fused column-condensed A @ (X W): each slot's gathered row "
        "transformed on chip and contracted at once, no (n, F) "
        "intermediate; CUDA kernel",
))
