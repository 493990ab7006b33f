"""Graph preprocessing: community reordering + N-way decomposition.

Counterpart of ``repro/core/decompose.py`` (paper §3.3): reorder with a
community tool, then traverse the edges once and split them by whether src
and dst fall in the same diagonal block of the reordered adjacency.  The
inter-community edges split further into ``inter_buckets`` density tiers.

Everything up to the payloads is numpy and equal to the reference's;
:meth:`DecomposeSkeleton.materialize` places the payloads on a device as
torch tensors.  The reorderer ported so far is ``bfs``; louvain/metis wait
for a later slice (ROADMAP slice A item 5).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import formats
from repro_torch.graphs.graph import Graph
from repro_torch.kernels.registry import DIAG, OFFDIAG, REGISTRY


# ---------------------------------------------------------------------------
# Community orderings
# ---------------------------------------------------------------------------

def bfs_reorder(n: int, senders: np.ndarray, receivers: np.ndarray,
                comm_size: int) -> np.ndarray:
    """Deterministic BFS clustering: grow clusters by BFS from the
    lowest-degree unvisited vertex.  Returns perm such that
    new_id = perm[old_id]."""
    # adjacency as CSR (undirected view)
    und_s = np.concatenate([senders, receivers])
    und_r = np.concatenate([receivers, senders])
    order = np.argsort(und_s, kind="stable")
    und_s, und_r = und_s[order], und_r[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(und_s, minlength=n), out=indptr[1:])
    deg = indptr[1:] - indptr[:-1]

    visited = np.zeros(n, bool)
    new_of_old = np.full(n, -1, np.int64)
    nxt = 0
    seeds = np.argsort(deg, kind="stable")
    seed_ptr = 0
    q: deque[int] = deque()
    while nxt < n:
        while seed_ptr < n and visited[seeds[seed_ptr]]:
            seed_ptr += 1
        if not q:
            if seed_ptr >= n:
                break
            q.append(int(seeds[seed_ptr]))
            visited[seeds[seed_ptr]] = True
        while q and nxt < n:
            v = q.popleft()
            new_of_old[v] = nxt
            nxt += 1
            for u in und_r[indptr[v]:indptr[v + 1]]:
                if not visited[u]:
                    visited[u] = True
                    q.append(int(u))
    if nxt != n or not (new_of_old >= 0).all():
        raise RuntimeError("bfs_reorder did not place every vertex")
    return new_of_old


REORDERERS = {"bfs": bfs_reorder}


# ---------------------------------------------------------------------------
# Decomposition result
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Subgraph:
    """One density tier of the decomposed graph.  ``formats`` maps kernel
    name -> the payload that kernel's registry ``build`` produced."""
    name: str
    kind: str            # diag | offdiag
    n_rows: int          # padded
    block_size: int
    formats: dict = None
    stats: Any = None


@dataclass(frozen=True)
class Decomposed:
    """Reordered + decomposed graph on one device: ``subgraphs[0]`` is the
    intra/diagonal tier, the rest are inter density buckets, sparsest
    first.  ``perm``/``inv_perm`` are int32 tensors on that device."""
    n: int
    n_pad: int
    block_size: int
    perm: torch.Tensor = None       # (n,) new_id of old_id
    inv_perm: torch.Tensor = None   # (n,) old_id of new_id
    subgraphs: tuple = ()
    stats: Any = None

    @property
    def intra(self) -> Subgraph:
        return self.subgraphs[0]

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def sub(self, name: str) -> Subgraph:
        for s in self.subgraphs:
            if s.name == name:
                return s
        raise KeyError(name)

    def to(self, device: str | torch.device) -> "Decomposed":
        """The same decomposition with every tensor on ``device``."""
        dev = resolve_device(device)
        subs = tuple(dataclasses.replace(
            s, formats={k: formats.to_device(p, dev)
                        for k, p in s.formats.items()})
            for s in self.subgraphs)
        return dataclasses.replace(self, perm=self.perm.to(dev),
                                   inv_perm=self.inv_perm.to(dev),
                                   subgraphs=subs)


def _tier_stats(kind: str, n_pad: int, block_size: int, rows: np.ndarray,
                cols: np.ndarray) -> dict:
    """Density statistics for one edge tier (the reference's full-batch
    keys: nnz, density, block-row and column occupancy)."""
    nnz = len(rows)
    denom = (n_pad * block_size if kind == DIAG else n_pad * n_pad)
    n_brow = max(n_pad // block_size, 1)
    occ = (len(np.unique(np.asarray(rows) // block_size)) / n_brow
           if nnz else 0.0)
    col_occ = 0.0
    if nnz:
        pairs = (np.asarray(rows, np.int64) // block_size) * np.int64(n_pad
                 ) + np.asarray(cols, np.int64)
        col_occ = len(np.unique(pairs)) / nnz
    return dict(nnz=nnz, density=nnz / max(denom, 1), brow_occupancy=occ,
                col_occupancy=col_occ)


def _materialize_subgraph(t: "TierEdges", n_pad: int, block_size: int,
                          device: torch.device) -> Subgraph:
    """Build every registered candidate payload of one tier (paper §3.3:
    once, so any kernel can run without re-conversion) on ``device``."""
    # fused specs alias an unfused spec's payload and build nothing
    specs = [s for s in REGISTRY.candidates(t.kind) if s.build is not None]
    coo = formats.coo_from_edges(n_pad, n_pad, t.rows, t.cols, t.vals)
    coo_t = (formats.coo_from_edges(n_pad, n_pad, t.cols, t.rows, t.vals)
             if any(s.needs_transpose for s in specs) else None)
    fmts = {s.name: formats.to_device(
                s.build(coo, coo_t, block_size, t.stats), device)
            for s in specs}
    return Subgraph(name=t.name, kind=t.kind, n_rows=n_pad,
                    block_size=block_size, formats=fmts, stats=dict(t.stats))


def _bucket_inter(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  n_brow: int, block_size: int, k: int) -> list[tuple]:
    """Partition inter edges into <=k tiers by destination block-row
    occupancy (sparsest tier first).  Tiers that receive no edges are
    dropped; k=1 is the identity partition."""
    if len(rows) == 0 or k <= 1:
        return [(rows, cols, vals)]
    brow = rows // block_size
    row_nnz = np.bincount(brow, minlength=n_brow)
    occupied = row_nnz[row_nnz > 0]
    qs = np.quantile(occupied, np.linspace(0.0, 1.0, k + 1)[1:-1])
    tier_of_row = np.searchsorted(qs, row_nnz, side="right")
    tier = tier_of_row[brow]
    out = []
    for t in range(k):
        m = tier == t
        if m.any():
            out.append((rows[m], cols[m], vals[m]))
    return out or [(rows, cols, vals)]


@dataclass(frozen=True)
class TierEdges:
    """One tier's partitioned (row-sorted) edge arrays + density stats."""
    name: str
    kind: str                    # diag | offdiag
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    stats: dict


@dataclass(frozen=True)
class DecomposeSkeleton:
    """Reorder + partition + stats, all host numpy; :meth:`materialize`
    builds the payloads."""
    n: int
    n_pad: int
    block_size: int
    perm: np.ndarray             # (n,) int32 new_id of old_id
    inv_perm: np.ndarray         # (n,) int32 old_id of new_id
    tiers: tuple                 # tuple[TierEdges, ...], intra first
    stats: dict

    def materialize(self, device: str | torch.device = DEFAULT_DEVICE
                    ) -> Decomposed:
        """Every tier's candidate payloads, placed on ``device``."""
        dev = resolve_device(device)
        subs = tuple(_materialize_subgraph(t, self.n_pad, self.block_size, dev)
                     for t in self.tiers)
        return Decomposed(
            n=self.n, n_pad=self.n_pad, block_size=self.block_size,
            perm=torch.as_tensor(self.perm).to(dev),
            inv_perm=torch.as_tensor(self.inv_perm).to(dev),
            subgraphs=subs, stats=dict(self.stats))


def decompose_skeleton(graph: Graph, comm_size: int = 16,
                       method: str = "bfs",
                       edge_vals: np.ndarray | None = None,
                       inter_buckets: int = 1) -> DecomposeSkeleton:
    """Steps 1-2 of the decomposition (reorder + partition + stats)."""
    n, B = graph.n, comm_size
    if method not in REORDERERS:
        raise NotImplementedError(
            f"reorder method {method!r} is not ported yet (only 'bfs'): "
            "ROADMAP slice A item 5")
    perm = REORDERERS[method](n, graph.senders, graph.receivers, B)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)

    rows = perm[graph.receivers]
    cols = perm[graph.senders]
    vals = (np.ones(len(rows), np.float32) if edge_vals is None
            else np.asarray(edge_vals, np.float32))

    n_pad = ((n + B - 1) // B) * B
    on_diag = (rows // B) == (cols // B)
    r_in, c_in, v_in = rows[on_diag], cols[on_diag], vals[on_diag]
    r_out, c_out, v_out = rows[~on_diag], cols[~on_diag], vals[~on_diag]

    def _tier(name, kind, r, c, v):
        order = np.argsort(r, kind="stable")
        r, c, v = r[order], c[order], v[order]
        return TierEdges(name, kind, r, c, v, _tier_stats(kind, n_pad, B, r, c))

    tiers = [_tier("intra", DIAG, r_in, c_in, v_in)]
    buckets = _bucket_inter(r_out, c_out, v_out, n_pad // B, B,
                            inter_buckets)
    for t, (rb, cb, vb) in enumerate(buckets):
        name = "inter" if len(buckets) == 1 else f"inter{t}"
        tiers.append(_tier(name, OFFDIAG, rb, cb, vb))

    return DecomposeSkeleton(
        n=n, n_pad=n_pad, block_size=B,
        perm=perm.astype(np.int32), inv_perm=inv.astype(np.int32),
        tiers=tuple(tiers),
        stats=dict(
            n=n, n_edges=len(rows), comm_size=B,
            method=method, effective_method=method,
            inter_buckets=len(buckets),
            intra_edges=int(on_diag.sum()), inter_edges=int((~on_diag).sum()),
            intra_density=float(on_diag.sum()) / max(n_pad * B, 1),
            inter_density=float((~on_diag).sum()) / max(n_pad * n_pad, 1),
            subgraphs=tuple((t.name, t.stats["nnz"], t.stats["density"])
                            for t in tiers),
        ),
    )


def decompose(graph: Graph, comm_size: int = 16, method: str = "bfs",
              edge_vals: np.ndarray | None = None, inter_buckets: int = 1,
              device: str | torch.device = DEFAULT_DEVICE) -> Decomposed:
    """Reorder, partition and materialize the payloads on ``device``
    (paper Fig. 7 line 19).  Aggregation convention: rows = receivers
    (dst), cols = senders (src)."""
    dev = resolve_device(device)
    return decompose_skeleton(
        graph, comm_size=comm_size, method=method, edge_vals=edge_vals,
        inter_buckets=inter_buckets).materialize(dev)
