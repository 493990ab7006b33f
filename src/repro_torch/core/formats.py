"""Sparse/dense graph storage formats used by AdaptGear's subgraph kernels.

Counterpart of ``repro/core/formats.py``.  The containers are frozen
dataclasses whose array fields hold numpy arrays while the host builds
them (one pass over the edges, paper §3.3) and torch tensors once
:func:`to_device` has placed them:

  COO       -- edge list (edge-parallel; ``index_add_``)
  CSR       -- row-compressed (vertex-parallel; gather + sorted reduce)
  ELL       -- per-row padded neighbor lists (regular gather)
  BlockDiag -- dense (B,B) diagonal blocks (intra-community; CUDA kernel)
  BlockELL  -- blocked-ELL: CSR over (B,B) blocks, padded to K blocks per
               block row (inter-community; CUDA kernel)

The builders are numpy and give byte-identical payloads to the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

Array = Any   # np.ndarray on the host, torch.Tensor once placed


def _np(arr) -> np.ndarray:
    """Host view of a (possibly device) array."""
    if isinstance(arr, np.ndarray):
        return arr
    return arr.detach().cpu().numpy()


@dataclass(frozen=True)
class COO:
    """Edge-list format. rows = destination, cols = source (paper §2.1)."""
    n_rows: int
    n_cols: int
    rows: Array = None   # (E,) int32, destination vertex per edge
    cols: Array = None   # (E,) int32, source vertex per edge
    vals: Array = None   # (E,) float32, edge weight (e.g. GCN normalization)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def density(self) -> float:
        return self.nnz / max(self.n_rows * self.n_cols, 1)


@dataclass(frozen=True)
class CSR:
    """Row-compressed edge list: row i's edges are
    ``indices[indptr[i]:indptr[i+1]]``."""
    n_rows: int
    n_cols: int
    indptr: Array = None   # (n_rows+1,) int32
    indices: Array = None  # (E,) int32 column (source) indices
    vals: Array = None     # (E,) float32

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


@dataclass(frozen=True)
class ELL:
    """Per-row padded neighbor lists.  indices[i, k] is the k-th source
    neighbor of row i (0 where padded, masked by ``mask``)."""
    n_rows: int
    n_cols: int
    max_deg: int
    indices: Array = None  # (n_rows, max_deg) int32
    vals: Array = None     # (n_rows, max_deg) float32, 0 where padded
    mask: Array = None     # (n_rows, max_deg) bool


@dataclass(frozen=True)
class BlockDiag:
    """Dense diagonal blocks: the intra-community subgraph after community
    reordering (paper Fig. 3a / §3.2 'Dense-based kernel')."""
    n: int            # padded node count
    block_size: int   # community size B
    blocks: Array = None   # (n // B, B, B) float32 dense adjacency blocks

    @property
    def n_blocks(self) -> int:
        return self.n // self.block_size

    @property
    def nnz(self) -> int:
        return int((_np(self.blocks) != 0).sum())

    @property
    def density(self) -> float:
        return self.nnz / max(_np(self.blocks).size, 1)


@dataclass(frozen=True)
class BlockELL:
    """CSR-of-blocks padded to K non-empty (B,B) blocks per block-row.

    ``col_idx[i, k]`` names the block column of the k-th stored block in
    block row i; padding entries point at block column 0 with an all-zero
    block, and ``n_valid[i]`` counts the real (leading) slots of row i.
    ``f_tile_cap`` is the reference's TPU feature-tile cap; it rides along
    only because it is part of the payload."""
    n_rows: int
    n_cols: int
    block_size: int
    max_blocks: int            # K
    f_tile_cap: int = 512
    budgeted: bool = False
    blocks: Array = None    # (n_brow, K, B, B) float32
    col_idx: Array = None   # (n_brow, K) int32 block-column ids
    n_valid: Array = None   # (n_brow,) int32 number of real blocks per row

    @property
    def n_brow(self) -> int:
        return self.n_rows // self.block_size


# array fields of every payload container; the kernel modules that own a
# container (kernels/sell_cs.py, kernels/tcgnn_tile.py) add theirs
ARRAY_FIELDS = {
    COO: ("rows", "cols", "vals"),
    CSR: ("indptr", "indices", "vals"),
    ELL: ("indices", "vals", "mask"),
    BlockDiag: ("blocks",),
    BlockELL: ("blocks", "col_idx", "n_valid"),
}


def to_device(payload, device: torch.device, copy=None):
    """Place a format container (or a tuple of them) on ``device``; every
    array field becomes a tensor of the same dtype there, through
    ``copy(host_array) -> tensor`` where given."""
    if isinstance(payload, tuple):
        return tuple(to_device(p, device, copy) for p in payload)
    if copy is None:
        copy = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    fields = ARRAY_FIELDS[type(payload)]
    return dataclasses.replace(payload, **{
        f: copy(_np(getattr(payload, f))) for f in fields})


def format_stats(fmt) -> dict:
    """Size and density statistics of a format container, the reference's
    keys per kind."""
    if isinstance(fmt, COO):
        return dict(kind="coo", nnz=fmt.nnz, n=fmt.n_rows,
                    density=fmt.density)
    if isinstance(fmt, CSR):
        return dict(kind="csr", nnz=fmt.nnz, n=fmt.n_rows)
    if isinstance(fmt, ELL):
        return dict(kind="ell", n=fmt.n_rows, max_deg=fmt.max_deg,
                    padded=fmt.n_rows * fmt.max_deg)
    if isinstance(fmt, BlockDiag):
        return dict(kind="block_diag", n_blocks=fmt.n_blocks,
                    block_size=fmt.block_size, density=fmt.density)
    if isinstance(fmt, BlockELL):
        return dict(kind="bell", n_brow=fmt.n_brow, max_blocks=fmt.max_blocks,
                    block_size=fmt.block_size)
    raise TypeError(type(fmt))


# ---------------------------------------------------------------------------
# Host-side (numpy) constructors.  Preprocessing is a single pass over the
# edge list, matching the paper's §3.3 decomposition procedure.
# ---------------------------------------------------------------------------

def coo_from_edges(n_rows: int, n_cols: int, rows: np.ndarray,
                   cols: np.ndarray, vals: np.ndarray | None = None) -> COO:
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    if vals is None:
        vals = np.ones(rows.shape[0], np.float32)
    # sort by destination row unless the caller already did (the decompose
    # skeleton row-sorts each tier once)
    if rows.size and np.any(rows[1:] < rows[:-1]):
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
        vals = np.asarray(vals, np.float32)[order]
    return COO(n_rows, n_cols, rows, cols, np.asarray(vals, np.float32))


def coo_to_csr(coo: COO) -> CSR:
    """Row pointer over a row-sorted COO (``coo_from_edges`` sorts)."""
    rows = _np(coo.rows)
    counts = np.bincount(rows, minlength=coo.n_rows)
    indptr = np.zeros(coo.n_rows + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSR(coo.n_rows, coo.n_cols, indptr, coo.cols, coo.vals)


def coo_to_ell(coo: COO) -> ELL:
    """Per-row neighbor lists padded to the largest in-degree."""
    rows = _np(coo.rows)
    cols = _np(coo.cols)
    vals = _np(coo.vals)
    counts = np.bincount(rows, minlength=coo.n_rows)
    K = max(int(counts.max()) if counts.size else 1, 1)
    idx = np.zeros((coo.n_rows, K), np.int32)
    v = np.zeros((coo.n_rows, K), np.float32)
    m = np.zeros((coo.n_rows, K), bool)
    slot = np.zeros(coo.n_rows, np.int32)
    for r, c, w in zip(rows, cols, vals):
        s = slot[r]
        if s < K:
            idx[r, s] = c
            v[r, s] = w
            m[r, s] = True
            slot[r] = s + 1
    return ELL(coo.n_rows, coo.n_cols, K, idx, v, m)


def coo_to_blockdiag(coo: COO, block_size: int) -> BlockDiag:
    """Densify assuming every edge lies on the diagonal blocks (the caller
    has already filtered to the intra-community subgraph)."""
    B = block_size
    n_pad = ((coo.n_rows + B - 1) // B) * B
    nb = n_pad // B
    rows = _np(coo.rows)
    cols = _np(coo.cols)
    vals = _np(coo.vals)
    blocks = np.zeros((nb, B, B), np.float32)
    b = rows // B
    if not np.all(b == cols // B):
        raise ValueError("coo_to_blockdiag: edge off the block diagonal")
    blocks[b, rows % B, cols % B] = vals
    return BlockDiag(n_pad, B, blocks)


def coo_to_bell(coo: COO, block_size: int, f_tile_cap: int = 512) -> BlockELL:
    """Blocked-ELL over (B,B) tiles; K = max non-empty blocks per block row.
    A row's blocks take slots in the order their first edge appears."""
    B = block_size
    n_rpad = ((coo.n_rows + B - 1) // B) * B
    n_cpad = ((coo.n_cols + B - 1) // B) * B
    nbr = n_rpad // B
    rows = _np(coo.rows)
    cols = _np(coo.cols)
    vals = _np(coo.vals)
    brow, bcol = rows // B, cols // B
    # group edges per (brow, bcol)
    blk_of: dict[tuple[int, int], int] = {}
    per_row: list[list[int]] = [[] for _ in range(nbr)]
    for r in range(len(rows)):
        key = (int(brow[r]), int(bcol[r]))
        if key not in blk_of:
            blk_of[key] = len(per_row[key[0]])
            per_row[key[0]].append(key[1])
    K = max((len(p) for p in per_row), default=1)
    K = max(K, 1)
    blocks = np.zeros((nbr, K, B, B), np.float32)
    col_idx = np.zeros((nbr, K), np.int32)
    n_valid = np.zeros((nbr,), np.int32)
    for (i, j), slot in blk_of.items():
        col_idx[i, slot] = j
    for i, p in enumerate(per_row):
        n_valid[i] = len(p)
    for r in range(len(rows)):
        i, j = int(brow[r]), int(bcol[r])
        blocks[i, blk_of[(i, j)], rows[r] % B, cols[r] % B] = vals[r]
    return BlockELL(n_rpad, n_cpad, B, K, f_tile_cap,
                    blocks=blocks, col_idx=col_idx, n_valid=n_valid)


# ---------------------------------------------------------------------------
# Budget-padded blocked-ELL (the mini-batch fixed-shape variant)
# ---------------------------------------------------------------------------

def bell_budget_k(edge_budget: int, n_pad: int, block_size: int,
                  slack: float = 2.0) -> int:
    """Stored-block cap K of the budget-padded blocked-ELL.

    A function of the sampler's edge budget alone, never of a batch's
    edges, so every batch's payload has one (n_brow, K, B, B) shape: K
    covers ``slack`` times the per-block-row average stored-block count
    under dense packing (each stored block absorbing about B edges),
    bounded above by the block-row count."""
    nbr = max(n_pad // block_size, 1)
    k = -(-int(slack * edge_budget) // max(nbr * block_size, 1))
    return int(max(1, min(k, nbr)))


def coo_to_bell_capped(coo: COO, block_size: int, k_max: int,
                       n_cols_pad: int | None = None,
                       f_tile_cap: int = 512, build_blocks: bool = True
                       ) -> tuple[BlockELL | None, COO, COO]:
    """Blocked-ELL with exactly ``k_max`` stored-block slots per block row.

    Rows needing more keep their densest ``k_max`` blocks (ties toward the
    lower block column); the other edges come back as a row-sorted spill
    COO, and the stored edges as a third COO.  Slots past a row's real
    block count are all-zero blocks pointing at block column 0, with
    ``n_valid`` counting the real ones.  Returns ``(bell, spill, stored)``
    with ``bell.budgeted=True``; ``build_blocks=False`` skips the
    (n_brow, K, B, B) scatter and returns ``bell=None``."""
    B = block_size
    n_rpad = ((coo.n_rows + B - 1) // B) * B
    n_cpad = n_cols_pad or ((coo.n_cols + B - 1) // B) * B
    nbr = n_rpad // B
    nbc = n_cpad // B
    K = int(max(1, min(k_max, nbc)))
    rows = _np(coo.rows)
    cols = _np(coo.cols)
    vals = _np(coo.vals)
    if build_blocks:
        blocks = np.zeros((nbr, K, B, B), np.float32)
        col_idx = np.zeros((nbr, K), np.int32)
        n_valid = np.zeros((nbr,), np.int32)

    if len(rows):
        brow = (rows // B).astype(np.int64)
        bcol = (cols // B).astype(np.int64)
        key = brow * nbc + bcol
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        ubrow, ubcol = uniq // nbc, uniq % nbc
        # a block's slot is its rank in its row, densest first (after the
        # lexsort rows are contiguous: rank = index - first in the row)
        order = np.lexsort((ubcol, -counts, ubrow))
        sorted_brow = ubrow[order]
        rank_sorted = (np.arange(len(uniq))
                       - np.searchsorted(sorted_brow, sorted_brow))
        slot = np.empty(len(uniq), np.int64)
        slot[order] = rank_sorted

        edge_slot = slot[inv]
        stored_m = edge_slot < K
        if build_blocks:
            sb = np.flatnonzero(slot < K)
            col_idx[ubrow[sb], slot[sb]] = ubcol[sb]
            n_valid[:] = np.minimum(np.bincount(ubrow, minlength=nbr), K)
            blocks[brow[stored_m], edge_slot[stored_m],
                   rows[stored_m] % B, cols[stored_m] % B] = vals[stored_m]
    else:
        stored_m = np.zeros(0, bool)

    bell = (BlockELL(n_rpad, n_cpad, B, K, f_tile_cap, budgeted=True,
                     blocks=blocks, col_idx=col_idx, n_valid=n_valid)
            if build_blocks else None)
    spill = coo_from_edges(n_rpad, n_cpad, rows[~stored_m], cols[~stored_m],
                           vals[~stored_m])
    stored = coo_from_edges(n_rpad, n_cpad, rows[stored_m], cols[stored_m],
                            vals[stored_m])
    return bell, spill, stored
