"""Graph preprocessing: community reordering + N-way decomposition.

Counterpart of ``repro/core/decompose.py`` (paper §3.3): reorder with a
community tool, then traverse the edges once and split them by whether src
and dst fall in the same diagonal block of the reordered adjacency.  The
inter-community edges split further into ``inter_buckets`` density tiers.

Everything up to the payloads is numpy and equal to the reference's;
:meth:`DecomposeSkeleton.materialize` places the payloads on a device as
torch tensors (or keeps them host numpy with ``device=None``, as the
mini-batch path does before it pads them to the edge budget).  A skeleton
built with ``edge_budget`` (the mini-batch path) gets budget-capped
blocked-ELL and tcgnn payloads, and ``keep_empty_buckets`` pins its tier
count.  Two reorderers play METIS's role, as in the reference:
``bfs`` (deterministic BFS clustering) and ``louvain`` (Louvain
communities, from the port's own copy of networkx's method in
``core/louvain.py``, so no networkx is needed); ``metis`` stands in as
``louvain`` with a warning (:func:`resolve_method`).
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import formats, louvain
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


def louvain_reorder(n: int, senders: np.ndarray, receivers: np.ndarray,
                    comm_size: int, seed: int = 0) -> np.ndarray:
    """Louvain communities (``core/louvain.py``, networkx's method) laid
    out contiguously, largest first, each community's nodes in id order.
    Returns perm such that new_id = perm[old_id]."""
    g = louvain.graph_from_edges(n, senders, receivers)
    comms = louvain.louvain_communities(g, seed=seed)
    new_of_old = np.full(n, -1, np.int64)
    nxt = 0
    for comm in sorted(comms, key=len, reverse=True):
        for v in sorted(comm):
            new_of_old[v] = nxt
            nxt += 1
    if nxt != n:
        raise RuntimeError("louvain_reorder did not place every vertex")
    return new_of_old


REORDERERS = {"bfs": bfs_reorder, "louvain": louvain_reorder,
              "metis": louvain_reorder}

_SUBSTITUTIONS = {"metis": "louvain"}
_warned_substitutions: set = set()


def resolve_method(method: str) -> str:
    """Map unavailable reorderers to their stand-in, warning once."""
    effective = _SUBSTITUTIONS.get(method, method)
    if effective != method and method not in _warned_substitutions:
        _warned_substitutions.add(method)
        warnings.warn(
            f"reorder method {method!r} is unavailable offline; substituting "
            f"{effective!r} (recorded as stats['effective_method'])",
            UserWarning, stacklevel=3)
    return effective


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
    def inters(self) -> tuple:
        return self.subgraphs[1:]

    @property
    def device(self) -> torch.device:
        """The payloads' device (the CPU for host numpy payloads)."""
        if isinstance(self.perm, torch.Tensor):
            return self.perm.device
        return torch.device("cpu")

    @functools.cached_property
    def inter_edges_i64(self) -> tuple:
        """``(rows, cols)`` of each inter tier's COO payload as int64
        tensors (what ``scatter_reduce`` and ``index_add_`` index with),
        made once per decomposition, beside the payloads: their int32
        bytes stay the reference's."""
        return tuple((s.formats["coo"].rows.long(),
                      s.formats["coo"].cols.long())
                     for s in self.subgraphs[1:])

    def sub(self, name: str) -> Subgraph:
        for s in self.subgraphs:
            if s.name == name:
                return s
        raise KeyError(name)

    def to(self, device: str | torch.device, copy=None) -> "Decomposed":
        """The same decomposition with every tensor on ``device``, copied
        by ``copy(host_array) -> tensor`` where given (the mini-batch
        pipeline's staging copy)."""
        dev = resolve_device(device)
        if copy is None:
            copy = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
        subs = tuple(dataclasses.replace(
            s, formats={k: formats.to_device(p, dev, copy)
                        for k, p in s.formats.items()})
            for s in self.subgraphs)
        return dataclasses.replace(
            self, perm=copy(self.perm), inv_perm=copy(self.inv_perm),
            subgraphs=subs)


def _tier_stats(kind: str, n_pad: int, block_size: int, rows: np.ndarray,
                cols: np.ndarray, edge_budget: int | None = None,
                bell_slack: float | None = None) -> dict:
    """Density statistics for one edge tier (the reference's keys: nnz,
    density, block-row and column occupancy).  ``edge_budget`` marks the
    tier budget-paddable (the capped builders read it), ``bell_slack``
    rides along as the caps' slack factor."""
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
    stats = dict(nnz=nnz, density=nnz / max(denom, 1), brow_occupancy=occ,
                 col_occupancy=col_occ)
    if edge_budget:
        stats["edge_budget"] = int(edge_budget)
        if bell_slack is not None:
            stats["bell_slack"] = float(bell_slack)
    return stats


def _materialize_subgraph(name: str, kind: str, n_pad: int, block_size: int,
                          rows: np.ndarray, cols: np.ndarray,
                          vals: np.ndarray, stats: dict,
                          device: torch.device | None,
                          kernels: Sequence[str] | None = None) -> Subgraph:
    """Build one tier's candidate payloads (paper §3.3: once, so any
    kernel can run without re-conversion) on ``device`` (host numpy where
    it is None): every registered one, or only those ``kernels`` name (a
    fused name builds its unfused spec's payload; ``()`` builds none).
    ``stats["kernels"]`` names every spec, fused aliases included, whose
    payload was built, as in the reference."""
    all_specs = REGISTRY.candidates(kind, include_fused=True)
    # fused specs alias an unfused spec's payload and build nothing
    specs = [s for s in all_specs if s.build is not None]
    if kernels is not None:
        wanted = {REGISTRY.get(k).payload_key for k in kernels
                  if REGISTRY.get(k).applies_to(kind)}
        specs = [s for s in specs if s.name in wanted]
    fmts = {}
    if specs:
        coo = formats.coo_from_edges(n_pad, n_pad, rows, cols, vals)
        coo_t = (formats.coo_from_edges(n_pad, n_pad, cols, rows, vals)
                 if any(s.wants_transpose(stats) for s in specs) else None)
        fmts = {s.name: s.build(coo, coo_t, block_size, stats)
                for s in specs}
        if device is not None:
            fmts = {k: formats.to_device(p, device) for k, p in fmts.items()}
    stats = dict(stats)
    stats["kernels"] = tuple(s.name for s in all_specs
                             if s.payload_key in fmts)
    return Subgraph(name=name, kind=kind, n_rows=n_pad,
                    block_size=block_size, formats=fmts, stats=stats)


def build_subgraph(name: str, kind: str, n_pad: int, block_size: int,
                   rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   kernels: Sequence[str] | None = None,
                   edge_budget: int | None = None, *,
                   device: str | torch.device = DEFAULT_DEVICE) -> Subgraph:
    """Materialize the candidate formats of one edge tier on ``device``:
    every registered one, or those ``kernels`` name (a fused name builds
    its unfused counterpart's payload).  Density stats come first and go
    to each format's build function, so formats pick their tiling per
    tier; with ``edge_budget`` the blocked-ELL and tcgnn payloads are the
    budget-capped triples (their stored blocks or columns capped from the
    budget alone, the overflow in a COO spill)."""
    stats = _tier_stats(kind, n_pad, block_size, rows, cols, edge_budget)
    return _materialize_subgraph(name, kind, n_pad, block_size, rows, cols,
                                 vals, stats, resolve_device(device), kernels)


def _bucket_inter(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  n_brow: int, block_size: int, k: int,
                  keep_empty: bool = False) -> list[tuple]:
    """Partition inter edges into <=k tiers by destination block-row
    occupancy (sparsest tier first).  Tiers that receive no edges are
    dropped unless ``keep_empty`` (the mini-batch path: exactly ``k``
    tiers, so every batch has one structure); k=1 is the identity
    partition."""
    if len(rows) == 0 or k <= 1:
        out = [(rows, cols, vals)]
        if keep_empty:
            out += [(rows[:0], cols[:0], vals[:0])] * (k - len(out))
        return out
    brow = rows // block_size
    row_nnz = np.bincount(brow, minlength=n_brow)
    occupied = row_nnz[row_nnz > 0]
    qs = np.quantile(occupied, np.linspace(0.0, 1.0, k + 1)[1:-1])
    tier_of_row = np.searchsorted(qs, row_nnz, side="right")
    tier = tier_of_row[brow]
    out = []
    for t in range(k):
        m = tier == t
        if keep_empty or m.any():
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
    builds the payloads.  The mini-batch path partitions each batch once
    into one, looks the PlanCache up on its stats (:attr:`subgraphs`) and
    materializes only the payloads the committed plan runs."""
    n: int
    n_pad: int
    block_size: int
    perm: np.ndarray             # (n,) int32 new_id of old_id
    inv_perm: np.ndarray         # (n,) int32 old_id of new_id
    tiers: tuple                 # tuple[TierEdges, ...], intra first
    stats: dict

    def materialize(self, kernels=None,
                    device: str | torch.device | None = DEFAULT_DEVICE
                    ) -> Decomposed:
        """A :class:`Decomposed` with the payloads of ``kernels`` (None:
        every registry candidate; ``()``: none) on ``device``, reusing the
        partition and stats.  ``kernels`` is one name sequence for every
        tier, or one collection of names per tier (the committed plan's
        keys, ``plan_cache.plan_payload_keys``).  ``device=None`` keeps
        the payloads and ``perm`` host numpy, as the reference's mini-batch
        path does until it pads them to the edge budget."""
        dev = None if device is None else resolve_device(device)
        per_tier = (tuple(kernels)
                    if (kernels is not None and len(kernels) == len(self.tiers)
                        and not any(isinstance(k, str) for k in kernels))
                    else (kernels,) * len(self.tiers))
        subs = tuple(_materialize_subgraph(t.name, t.kind, self.n_pad,
                                           self.block_size, t.rows, t.cols,
                                           t.vals, t.stats, dev, ks)
                     for t, ks in zip(self.tiers, per_tier))
        perm, inv_perm = self.perm, self.inv_perm
        if dev is not None:
            perm = torch.as_tensor(perm).to(dev)
            inv_perm = torch.as_tensor(inv_perm).to(dev)
        return Decomposed(
            n=self.n, n_pad=self.n_pad, block_size=self.block_size,
            perm=perm, inv_perm=inv_perm, subgraphs=subs,
            stats=dict(self.stats))

    @property
    def subgraphs(self) -> tuple:
        """The tiers, read as a Decomposed's subgraphs: they carry the
        same ``name``, ``kind`` and ``stats``, which is all the PlanCache's
        signature reads."""
        return self.tiers

    def stats_only(self) -> Decomposed:
        """The payload-free host view (``materialize((), device=None)``),
        made once."""
        cached = self.__dict__.get("_stats_only")
        if cached is None:
            cached = self.materialize((), device=None)
            object.__setattr__(self, "_stats_only", cached)
        return cached


def decompose_skeleton(graph: Graph, comm_size: int = 16,
                       method: str = "bfs",
                       edge_vals: np.ndarray | None = None,
                       reorder: bool = True, inter_buckets: int = 1,
                       keep_empty_buckets: bool = False,
                       edge_budget: int | None = None,
                       bell_slack: float | None = None) -> DecomposeSkeleton:
    """Steps 1-2 of the decomposition (reorder + partition + stats).
    ``reorder=False`` keeps the graph's own node order; otherwise
    ``method`` is resolved (:func:`resolve_method`) and the stand-in
    actually run is ``stats["effective_method"]``.  ``keep_empty_buckets``
    keeps exactly ``inter_buckets`` inter tiers, empty ones included;
    ``edge_budget`` lands in every tier's stats and switches the
    blocked-ELL and tcgnn builders to their budget-capped payloads, with
    ``bell_slack`` as the caps' slack factor."""
    n, B = graph.n, comm_size
    effective = method
    if reorder:
        effective = resolve_method(method)
        perm = REORDERERS[effective](n, graph.senders, graph.receivers, B)
    else:
        perm = np.arange(n, dtype=np.int64)
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
        return TierEdges(name, kind, r, c, v,
                         _tier_stats(kind, n_pad, B, r, c, edge_budget,
                                     bell_slack))

    tiers = [_tier("intra", DIAG, r_in, c_in, v_in)]
    buckets = _bucket_inter(r_out, c_out, v_out, n_pad // B, B,
                            inter_buckets, keep_empty=keep_empty_buckets)
    for t, (rb, cb, vb) in enumerate(buckets):
        name = "inter" if len(buckets) == 1 else f"inter{t}"
        tiers.append(_tier(name, OFFDIAG, rb, cb, vb))

    return DecomposeSkeleton(
        n=n, n_pad=n_pad, block_size=B,
        perm=perm.astype(np.int32), inv_perm=inv.astype(np.int32),
        tiers=tuple(tiers),
        stats=dict(
            n=n, n_edges=len(rows), comm_size=B,
            method=method, effective_method=effective,
            inter_buckets=len(buckets),
            intra_edges=int(on_diag.sum()), inter_edges=int((~on_diag).sum()),
            intra_density=float(on_diag.sum()) / max(n_pad * B, 1),
            inter_density=float((~on_diag).sum()) / max(n_pad * n_pad, 1),
            subgraphs=tuple((t.name, t.stats["nnz"], t.stats["density"])
                            for t in tiers),
        ),
    )


def decompose(graph: Graph, comm_size: int = 16, method: str = "bfs",
              edge_vals: np.ndarray | None = None, reorder: bool = True,
              inter_buckets: int = 1,
              kernels: Sequence[str] | None = None,
              keep_empty_buckets: bool = False,
              edge_budget: int | None = None,
              bell_slack: float | None = None,
              device: str | torch.device = DEFAULT_DEVICE) -> Decomposed:
    """Reorder, partition and materialize the payloads of ``kernels``
    (None: every candidate) on ``device`` (paper Fig. 7 line 19); the
    mini-batch options as in :func:`decompose_skeleton`.  Aggregation
    convention: rows = receivers (dst), cols = senders (src)."""
    dev = resolve_device(device)
    return decompose_skeleton(
        graph, comm_size=comm_size, method=method, edge_vals=edge_vals,
        reorder=reorder, inter_buckets=inter_buckets,
        keep_empty_buckets=keep_empty_buckets, edge_budget=edge_budget,
        bell_slack=bell_slack).materialize(kernels, device=dev)


def decomposition_quality(dec: Decomposed) -> dict:
    """Fig. 4-style densities: full vs intra vs inter (buckets merged)."""
    s = dec.stats
    full_density = s["n_edges"] / max(dec.n_pad ** 2, 1)
    return dict(full=full_density, intra=s["intra_density"],
                inter=s["inter_density"],
                intra_frac=s["intra_edges"] / max(s["n_edges"], 1))
