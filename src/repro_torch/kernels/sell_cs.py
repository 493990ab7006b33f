"""Sell-C-sigma (sliced ELL over degree-sorted rows) aggregation: the
``sell_cs`` and ``sell_fused`` registry entries.

Counterpart of ``repro/kernels/sell_cs.py`` (Kreutzer et al., SIAM J.
Sci. Comput. 2014).  Rows are sorted by degree inside windows of
``sigma`` rows and cut into chunks of ``chunk`` rows, each padded only to
its own largest degree, so one hub row no longer pads every row as in
ELL.  The builder is numpy and gives the reference's payload byte for
byte.  The reference's device pass is XLA (a flat gather over the padded
slots, a sorted segment-sum, a gather back to row order), so the port is
plain PyTorch on any device, differentiable through autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.kernels import ref
from repro_torch.kernels.registry import (DIAG, OFFDIAG, REGISTRY,
                                          KernelSpec, _bytes_el)

CHUNK = 8          # rows per chunk
SIGMA_CHUNKS = 8   # sigma = SIGMA_CHUNKS * chunk rows per sort window


@dataclass(frozen=True)
class SellCS:
    """Chunk-padded slices of the degree-sorted matrix, flattened."""
    n_rows: int
    n_cols: int
    chunk: int
    sigma: int
    indices: Any = None   # (P,) int32 source (column) ids, 0 where padded
    vals: Any = None      # (P,) float32, 0 where padded
    srow: Any = None      # (P,) int32 degree-sorted row index, nondecreasing
    rank: Any = None      # (n_rows,) int32: row id -> degree-sorted position

    @property
    def n_slots(self) -> int:
        return int(self.indices.shape[0])


formats.ARRAY_FIELDS[SellCS] = ("indices", "vals", "srow", "rank")


def coo_to_sell(coo: formats.COO, chunk: int = CHUNK,
                sigma: int | None = None) -> SellCS:
    """Degree-sort within sigma windows, chunk, pad each chunk to its own
    largest degree, flatten chunk-major (host numpy, vectorized)."""
    n = coo.n_rows
    sigma = sigma or chunk * SIGMA_CHUNKS
    rows, cols, vals = (formats._np(coo.rows), formats._np(coo.cols),
                        formats._np(coo.vals))
    if rows.size and np.any(np.diff(rows) < 0):   # builder needs row-sorted
        edge_order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[edge_order], cols[edge_order], vals[edge_order]
    deg = np.bincount(rows, minlength=n)
    # stable degree sort inside each sigma window (the window id is the
    # primary key, so the community order survives across windows)
    window = np.arange(n) // sigma
    order = np.lexsort((np.arange(n), -deg, window))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    # chunk-local widths; each sorted row owns w[its chunk] slots
    n_ch = -(-n // chunk)
    deg_sorted = np.zeros(n_ch * chunk, np.int64)
    deg_sorted[:n] = deg[order]
    w = deg_sorted.reshape(n_ch, chunk).max(axis=1)
    slots_per_row = np.repeat(w, chunk)[:n]
    row_off = np.zeros(n + 1, np.int64)
    np.cumsum(slots_per_row, out=row_off[1:])
    P = int(row_off[-1])
    # per-edge slot: its position within its (row-sorted) row
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    slot = np.arange(len(rows), dtype=np.int64) - indptr[rows]
    flat = row_off[rank[rows]] + slot
    indices = np.zeros(P, np.int32)
    out_vals = np.zeros(P, np.float32)
    indices[flat] = cols
    out_vals[flat] = vals
    srow = np.repeat(np.arange(n, dtype=np.int32), slots_per_row)
    return SellCS(n, coo.n_cols, chunk, sigma, indices, out_vals, srow,
                  rank.astype(np.int32))


def _unsort(p: SellCS, msgs: torch.Tensor, dtype) -> torch.Tensor:
    """Reduce the slots per degree-sorted row, then gather back to row
    order."""
    y = torch.zeros((p.n_rows, msgs.shape[-1]), dtype=msgs.dtype,
                    device=msgs.device)
    y = y.index_add(0, p.srow.long(), msgs)
    return y.index_select(0, p.rank.long()).to(dtype)


def sell_matvec(p: SellCS, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ x over the chunk-padded slots."""
    acc = ref._acc(x)
    msgs = (x.index_select(0, p.indices.long()).to(acc)
            * p.vals.to(acc)[:, None])
    return _unsort(p, msgs, x.dtype)


def _sell_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    P = sub.formats["sell_cs"].n_slots      # nnz + chunk-local padding only
    n = sub.n_rows
    flops = 2.0 * P * feat_dim
    # padded-slot gather + slot metadata + output write + un-sort gather
    bytes_ = P * (feat_dim * be + 8) + 2.0 * n * feat_dim * be
    return max(flops / hw.peak_flops,
               bytes_ / (hw.hbm_bw * hw.gather_eff)) + hw.launch_overhead_s


REGISTRY.register(KernelSpec(
    name="sell_cs",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=lambda coo, coo_t, B, stats: coo_to_sell(coo),
    matvec=sell_matvec,
    cost=_sell_cost,
    doc="sell-C-sigma: degree-sorted chunk-padded slices (pads to the "
        "chunk's own largest degree instead of ELL's global one)",
))


def sell_transform_matvec(p: SellCS, x: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Y = A @ (x @ w) with each stored slot transforming its gathered
    source row: the reduce and the un-sort run at the output width."""
    acc = ref._acc(x)
    h = ((x.index_select(0, p.indices.long()) @ w).to(acc)
         * p.vals.to(acc)[:, None])
    return _unsort(p, h, x.dtype)


def _sell_fused_cost(sub, feat_dims, dtype, hw) -> float:
    fin, fout = feat_dims
    be = _bytes_el(dtype)
    P = sub.formats["sell_cs"].n_slots
    flops = 2.0 * P * (fin * fout + fout)
    bytes_ = P * (fin * be + fout * be + 8) + 2.0 * sub.n_rows * fout * be
    return max(flops / hw.peak_flops,
               bytes_ / (hw.hbm_bw * hw.gather_eff)) + hw.launch_overhead_s


REGISTRY.register(KernelSpec(
    name="sell_fused",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=None,
    payload_of="sell_cs",
    matvec=None,
    fused_matvec=sell_transform_matvec,
    cost=_sell_fused_cost,
    doc="fused sell-C-sigma A @ (X W): per-slot gathered transform over "
        "the degree-sorted chunks, no (n, F) intermediate",
))
