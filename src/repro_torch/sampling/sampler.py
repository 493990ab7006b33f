"""Mini-batch samplers emitting fixed-shape padded :class:`SampledBatch`es.

Counterpart of ``repro/sampling/sampler.py``.  Numpy throughout, so a
batch is byte-identical to the reference's for the same graph, seed and
batch index.

Two samplers, both host-side numpy (sampling is preprocessing, like the
paper's §3.3 decomposition) and both deterministic under a fixed seed:

* :class:`ClusterSampler` — Cluster-GCN-style community-block sampling.
  The full graph is reordered once with the same community orderings
  ``decompose`` uses (``REORDERERS``); a *cluster* is one ``block``-sized
  slice of the reordered id space, i.e. exactly one diagonal block of the
  full-graph decomposition.  A batch is the induced subgraph over ``q``
  randomly drawn clusters (epoch-shuffled without replacement, Chiang et
  al.'s stochastic multiple partitions), laid out so cluster ``j`` occupies
  local rows ``[j*block, (j+1)*block)`` — the per-batch
  ``decompose(reorder=False)`` then lands intra-cluster edges on the
  diagonal for free.

* :class:`NeighborSampler` — layer-wise neighbor sampling (GraphSAGE):
  seed nodes plus up to ``fanout[l]`` sampled in-neighbors per node per
  layer.  Only the seeds carry loss (``target_mask``).  Sampled nodes are
  sorted by the precomputed community ordering so the per-batch
  decomposition still finds what little block structure a neighbor-sampled
  subgraph has; the degree profile it produces is the scale-free skew the
  sell-C-sigma kernel targets.

Every batch is padded to a fixed ``node_budget`` x ``edge_budget`` (zero
features / masked rows / dropped-edge accounting), so the train step sees
the same shapes and dtypes batch after batch.

``sample()`` is split into a cheap, lock-protected :meth:`draw` that
consumes the *sequential* epoch state and pins batch ``index``'s
cluster/seed set in a :class:`DrawTicket`, and a pure, thread-safe
:meth:`build` that does the heavy work (induced edges, feature gather,
padding).  All randomness inside ``build`` comes from a per-batch stream
that is a pure function of (sampler seed, batch index) — epoch
permutations likewise key off (seed, epoch number) — so batches built out
of order (the reference's async pipeline, not ported yet) equal
sequential ``sample()`` calls under the same seed.
"""
from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.decompose import REORDERERS, resolve_method
from repro_torch.graphs.graph import Graph

# stream tags keep the per-epoch and per-batch child streams disjoint
_EPOCH_TAG = 0x9E3779B9
_BATCH_TAG = 0x85EBCA6B


def _stream_rng(entropy: int, tag: int, index: int) -> np.random.Generator:
    """Deterministic child stream: a pure function of (sampler seed, stream
    tag, index).  Batch i's randomness no longer depends on how many draws
    preceded it, which is what lets pipeline workers build batches on any
    thread in any order yet bit-identical to the sequential path."""
    return np.random.default_rng(
        np.random.SeedSequence((entropy, tag, index)))


@dataclass(frozen=True)
class DrawTicket:
    """Snapshot of one sequential draw: everything :meth:`build` needs to
    construct batch ``index`` deterministically on any thread."""
    index: int           # 0-based position in the sampler's batch stream
    chosen: np.ndarray   # clusters (ClusterSampler) | seeds (NeighborSampler)


@dataclass
class SampledBatch:
    """One fixed-shape mini-batch (host numpy; the train loop copies it to
    the device).  All arrays are padded to the sampler's budgets.

    ``nodes[i]`` is the original graph id of local row ``i`` (-1 where
    padded); edges are in *local* ids with the aggregation convention of
    the rest of the system (receivers = dst rows, senders = src cols).
    """
    n: int                     # node budget (== len(nodes))
    nodes: np.ndarray          # (n,) int32 original ids, -1 padding
    node_mask: np.ndarray      # (n,) bool, True where a real node sits
    senders: np.ndarray        # (edge_budget,) int32 local src, 0 padding
    receivers: np.ndarray      # (edge_budget,) int32 local dst, 0 padding
    edge_mask: np.ndarray      # (edge_budget,) bool
    features: np.ndarray       # (n, F) float32, 0 where padded
    labels: np.ndarray         # (n,) int32, 0 where padded
    target_mask: np.ndarray    # (n,) bool — rows that carry loss
    meta: dict = field(default_factory=dict)

    @property
    def n_real_nodes(self) -> int:
        return int(self.node_mask.sum())

    @property
    def n_real_edges(self) -> int:
        return int(self.edge_mask.sum())

    def real_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """(senders, receivers) restricted to real (unpadded) edges."""
        m = self.edge_mask
        return self.senders[m], self.receivers[m]


def _pack_edges(src: np.ndarray, dst: np.ndarray, edge_budget: int,
                meta: dict, rng: np.random.Generator | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncate to the budget and pad with masked (0, 0) entries.

    Over-budget batches keep a *random* subset (drawn from the sampler's
    seeded rng, so runs stay reproducible): a deterministic prefix cut
    would drop the same structural edges every time a batch recurs,
    silently biasing training.  The dropped count lands in ``meta``."""
    n_e = len(src)
    dropped = max(n_e - edge_budget, 0)
    if dropped:
        warnings.warn(
            f"sampled batch exceeds edge budget ({n_e} > {edge_budget}); "
            f"dropping a random {dropped}-edge subset — raise the budget "
            "to train on every induced edge", UserWarning, stacklevel=3)
        if rng is not None:
            keep = np.sort(rng.choice(n_e, edge_budget, replace=False))
        else:
            keep = np.arange(edge_budget)
        src, dst = src[keep], dst[keep]
        n_e = edge_budget
    s = np.zeros(edge_budget, np.int32)
    d = np.zeros(edge_budget, np.int32)
    m = np.zeros(edge_budget, bool)
    s[:n_e], d[:n_e], m[:n_e] = src, dst, True
    meta["dropped_edges"] = dropped
    return s, d, m


def _gather_node_arrays(graph: Graph, nodes: np.ndarray,
                        node_mask: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    feats = np.zeros((len(nodes), graph.features.shape[-1]), np.float32)
    labels = np.zeros(len(nodes), np.int32)
    real = node_mask.nonzero()[0]
    feats[real] = graph.features[nodes[real]]
    labels[real] = graph.labels[nodes[real]]
    return feats, labels


class ClusterSampler:
    """Community-block (Cluster-GCN) sampler over precomputed orderings.

    ``node_budget`` is implied: ``clusters_per_batch * block`` (each drawn
    cluster owns its full block of local rows, partially-filled clusters
    padded in place so the per-batch block-diagonal split stays aligned).
    """

    def __init__(self, graph: Graph, block: int = 16,
                 clusters_per_batch: int = 8, method: str = "louvain",
                 edge_budget: int | None = None, seed: int = 0):
        self.graph = graph
        self.block = block
        self.q = min(clusters_per_batch,
                     max((graph.n + block - 1) // block, 1))
        self.node_budget = self.q * block
        # one reordering for the whole run — the same community structure
        # decompose() would compute, reused across every batch
        self.perm = REORDERERS[resolve_method(method)](
            graph.n, graph.senders, graph.receivers, block)
        self.n_clusters = (graph.n + block - 1) // block
        # members[c] = original ids of cluster c, in reordered order
        order = np.argsort(self.perm, kind="stable")   # old id of new id
        self.members = [order[c * block: (c + 1) * block]
                        for c in range(self.n_clusters)]
        frac = self.node_budget / max(graph.n, 1)
        self.edge_budget = (int(edge_budget) if edge_budget else
                            max(1024, int(4 * graph.n_edges * frac)))
        self.seed = int(seed)
        self._entropy = self.seed & ((1 << 63) - 1)
        self._lock = threading.Lock()
        self._epoch: list[int] = []
        self._epoch_no = 0
        self._n_drawn = 0

    def _draw_clusters(self) -> np.ndarray:
        # epoch-shuffled without replacement; when a batch straddles an
        # epoch boundary, an id already drawn for *this batch* is deferred
        # to later in the fresh epoch (not dropped — it must still get its
        # draw) so a batch never contains a duplicate cluster, which would
        # duplicate its nodes and double-count them in the masked loss.
        # Epoch e's permutation keys off (seed, e), not a mutating rng, so
        # the stream is reproducible from the draw count alone.
        out: list[int] = []
        while len(out) < self.q:
            if not self._epoch:
                self._epoch = _stream_rng(
                    self._entropy, _EPOCH_TAG, self._epoch_no).permutation(
                        self.n_clusters).tolist()[::-1]
                self._epoch_no += 1
            c = self._epoch.pop()
            if c in out:
                self._epoch.insert(0, c)
            else:
                out.append(c)
        return np.asarray(sorted(out))

    def draw(self) -> DrawTicket:
        """Consume the sequential epoch stream (thread-safe, cheap — a few
        list pops) and pin batch ``index``'s cluster set; the heavy
        :meth:`build` may then run on any thread."""
        with self._lock:
            idx = self._n_drawn
            self._n_drawn += 1
            chosen = self._draw_clusters()
        return DrawTicket(idx, chosen)

    def fast_forward(self, n: int) -> None:
        """Advance the sequential draw state to draw number ``n`` (resume
        path: the next :meth:`draw` returns the ticket batch ``n`` of the
        uninterrupted stream would have).  The epoch state is a pure
        function of the draw count, so replaying the draws — a few list
        pops each, no batch builds — reproduces it exactly."""
        if n < self._n_drawn:
            raise ValueError(f"cannot rewind sampler: {n} < {self._n_drawn} "
                             "draws already consumed")
        while self._n_drawn < n:
            self.draw()

    def build(self, ticket: DrawTicket) -> SampledBatch:
        """Materialize the ticket's batch: pure given the ticket (per-batch
        randomness streams off (seed, ticket.index)), so it is thread-safe
        and order-independent."""
        chosen = ticket.chosen
        B, nb = self.block, self.node_budget
        nodes = np.full(nb, -1, np.int64)
        node_mask = np.zeros(nb, bool)
        local_of = np.full(self.graph.n, -1, np.int64)
        for j, c in enumerate(chosen):
            mem = self.members[c]
            nodes[j * B: j * B + len(mem)] = mem
            node_mask[j * B: j * B + len(mem)] = True
            local_of[mem] = j * B + np.arange(len(mem))
        # induced edges: both endpoints inside the drawn clusters
        ls = local_of[self.graph.senders]
        lr = local_of[self.graph.receivers]
        keep = (ls >= 0) & (lr >= 0)
        meta = dict(clusters=chosen.tolist())
        s, d, m = _pack_edges(ls[keep].astype(np.int32),
                              lr[keep].astype(np.int32),
                              self.edge_budget, meta,
                              rng=_stream_rng(self._entropy, _BATCH_TAG,
                                              ticket.index))
        feats, labels = _gather_node_arrays(self.graph,
                                            nodes.astype(np.int64),
                                            node_mask)
        return SampledBatch(
            n=nb, nodes=nodes.astype(np.int32), node_mask=node_mask,
            senders=s, receivers=d, edge_mask=m, features=feats,
            labels=labels, target_mask=node_mask.copy(), meta=meta)

    def sample(self) -> SampledBatch:
        return self.build(self.draw())


class NeighborSampler:
    """Layer-wise in-neighbor sampling: ``batch_nodes`` loss-carrying seeds,
    expanded by ``fanouts`` rounds of up-to-``f`` sampled in-neighbors.

    Budgets are the construction worst case (fixed, so shapes never vary):
    ``node_budget = batch_nodes * (1 + f1 + f1*f2 + ...)`` and
    ``edge_budget = batch_nodes * (f1 + f1*f2 + ...)``, each clamped to
    what the graph can actually supply (distinct nodes <= n, distinct
    edges <= n_edges — without the clamp a small graph would pad every
    batch larger than the graph itself).
    """

    def __init__(self, graph: Graph, batch_nodes: int = 128,
                 fanouts: tuple = (8, 4), method: str = "louvain",
                 block: int = 16, seed: int = 0):
        self.graph = graph
        self.batch_nodes = min(batch_nodes, graph.n)
        self.fanouts = tuple(int(f) for f in fanouts)
        widths = [self.batch_nodes]
        for f in self.fanouts:
            widths.append(min(widths[-1] * f, graph.n_edges))
        self.node_budget = (-(-min(sum(widths), graph.n) // block) * block)
        self.edge_budget = max(min(sum(widths[1:]), graph.n_edges), 1)
        # in-neighbor CSR (aggregation gathers from in-neighbors)
        order = np.argsort(graph.receivers, kind="stable")
        self._srt_src = graph.senders[order]
        counts = np.bincount(graph.receivers, minlength=graph.n)
        self._indptr = np.zeros(graph.n + 1, np.int64)
        np.cumsum(counts, out=self._indptr[1:])
        # community order used to lay sampled nodes out in blocks
        self.perm = REORDERERS[resolve_method(method)](
            graph.n, graph.senders, graph.receivers, block)
        self.seed = int(seed)
        self._entropy = self.seed & ((1 << 63) - 1)
        self._lock = threading.Lock()
        self._epoch: list[int] = []
        self._epoch_no = 0
        self._n_drawn = 0

    def _draw_seeds(self) -> np.ndarray:
        # same epoch-boundary defer-dedup as ClusterSampler._draw_clusters:
        # a duplicate seed would emit its sampled in-edges twice
        out: list[int] = []
        seen: set[int] = set()
        while len(out) < self.batch_nodes:
            if not self._epoch:
                self._epoch = _stream_rng(
                    self._entropy, _EPOCH_TAG, self._epoch_no).permutation(
                        self.graph.n).tolist()[::-1]
                self._epoch_no += 1
            v = self._epoch.pop()
            if v in seen:
                self._epoch.insert(0, v)
            else:
                seen.add(v)
                out.append(v)
        return np.asarray(out, np.int64)

    def _sample_neighbors(self, v: int, fanout: int,
                          rng: np.random.Generator) -> np.ndarray:
        lo, hi = self._indptr[v], self._indptr[v + 1]
        deg = hi - lo
        if deg <= fanout:
            return self._srt_src[lo:hi]
        pick = rng.choice(deg, size=fanout, replace=False)
        return self._srt_src[lo + np.sort(pick)]

    def draw(self) -> DrawTicket:
        """Consume the sequential seed-epoch stream (thread-safe, cheap);
        the fanout expansion happens in :meth:`build` off the ticket's
        per-batch rng stream."""
        with self._lock:
            idx = self._n_drawn
            self._n_drawn += 1
            seeds = self._draw_seeds()
        return DrawTicket(idx, seeds)

    def fast_forward(self, n: int) -> None:
        """Advance the sequential draw state to draw number ``n`` by
        replaying draws (see :meth:`ClusterSampler.fast_forward`)."""
        if n < self._n_drawn:
            raise ValueError(f"cannot rewind sampler: {n} < {self._n_drawn} "
                             "draws already consumed")
        while self._n_drawn < n:
            self.draw()

    def ego_ticket(self, seeds, index: int) -> DrawTicket:
        """Ticket for an *ego-net query* (serving): expand the caller's own
        seed set instead of consuming the training epoch stream.

        Seeds are validated, deduped and sorted — :meth:`build` assumes a
        duplicate-free seed set (a duplicate would emit its sampled
        in-edges twice and overflow the edge budget), and sorting makes
        the batch a pure function of the seed *set*, not the caller's
        ordering.  ``index`` picks the per-query rng stream, so the same
        (seeds, index) pair reproduces the same :class:`SampledBatch`
        bit-for-bit on any thread — the property the micro-batcher's
        retries rely on.  At most ``batch_nodes`` seeds fit one batch
        (fewer is fine: padding absorbs the slack)."""
        seeds = np.unique(np.asarray(seeds, np.int64))
        if seeds.size == 0:
            raise ValueError("ego_ticket needs at least one seed node")
        if seeds[0] < 0 or seeds[-1] >= self.graph.n:
            raise ValueError(
                f"seed ids must lie in [0, {self.graph.n}); got "
                f"[{seeds[0]}, {seeds[-1]}]")
        if seeds.size > self.batch_nodes:
            raise ValueError(
                f"{seeds.size} seeds exceed batch_nodes={self.batch_nodes}")
        return DrawTicket(int(index), seeds)

    def build(self, ticket: DrawTicket) -> SampledBatch:
        """Fanout expansion + padding for one ticket: thread-safe (reads
        only the immutable CSR/ordering arrays; randomness streams off
        (seed, ticket.index))."""
        rng = _stream_rng(self._entropy, _BATCH_TAG, ticket.index)
        seeds = ticket.chosen
        in_batch = set(seeds.tolist())
        frontier = seeds
        edges_s: list[np.ndarray] = []
        edges_d: list[np.ndarray] = []
        for f in self.fanouts:
            nxt: list[int] = []
            for v in frontier:
                nbr = self._sample_neighbors(int(v), f, rng)
                if len(nbr) == 0:
                    continue
                edges_s.append(nbr)
                edges_d.append(np.full(len(nbr), v, np.int64))
                for u in nbr.tolist():
                    if u not in in_batch:
                        in_batch.add(u)
                        nxt.append(u)
            frontier = np.asarray(nxt, np.int64)
        batch_nodes = np.fromiter(in_batch, np.int64, len(in_batch))
        # community order: the per-batch decomposition inherits whatever
        # block structure the full-graph ordering gives these nodes
        batch_nodes = batch_nodes[np.argsort(self.perm[batch_nodes],
                                             kind="stable")]
        nb = self.node_budget
        nodes = np.full(nb, -1, np.int64)
        node_mask = np.zeros(nb, bool)
        nodes[: len(batch_nodes)] = batch_nodes
        node_mask[: len(batch_nodes)] = True
        local_of = np.full(self.graph.n, -1, np.int64)
        local_of[batch_nodes] = np.arange(len(batch_nodes))
        src = local_of[np.concatenate(edges_s) if edges_s
                       else np.zeros(0, np.int64)]
        dst = local_of[np.concatenate(edges_d) if edges_d
                       else np.zeros(0, np.int64)]
        meta = dict(seeds=len(seeds), sampled_nodes=len(batch_nodes))
        s, d, m = _pack_edges(src.astype(np.int32), dst.astype(np.int32),
                              self.edge_budget, meta, rng=rng)
        feats, labels = _gather_node_arrays(self.graph, nodes, node_mask)
        target = np.zeros(nb, bool)
        target[local_of[seeds]] = True
        return SampledBatch(
            n=nb, nodes=nodes.astype(np.int32), node_mask=node_mask,
            senders=s, receivers=d, edge_mask=m, features=feats,
            labels=labels, target_mask=target, meta=meta)

    def sample(self) -> SampledBatch:
        return self.build(self.draw())
