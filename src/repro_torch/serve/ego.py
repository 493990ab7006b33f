"""Ego-net batch construction for serving: one NeighborSampler per
degradation rung.

Counterpart of ``repro/serve/ego.py``: batches are the reference's byte
for byte for the same rung, seed set and stream index.

A *rung* is a fanout configuration (rung 0 = the training fanouts, later
rungs progressively smaller — see serve/degrade.py).  Each rung owns its
own :class:`~repro_torch.sampling.sampler.NeighborSampler` because the
fanouts fix the node/edge budgets and with them every padded payload
shape: one rung == one set of payload shapes == one shape record per
plan in the server.  The samplers' pure ``build()`` path does all the
work — serving batches are bit-identical to what training would sample
for the same (seed set, stream index), which is what lets the server
reuse the training PlanCache and the training-calibrated cost model
unchanged.

Request randomness streams off a dedicated index space: every query
batch gets a fresh monotonically increasing index, so retries of a
failed build reproduce the same batch (the retry re-runs the same
ticket) while distinct queries decorrelate.
"""
from __future__ import annotations

import itertools
import threading

from repro_torch.core import gnn
from repro_torch.graphs import graph as graph_mod
from repro_torch.sampling.sampler import NeighborSampler, SampledBatch

__all__ = ["EgoNetSampler", "default_rungs"]


def default_rungs(fanouts: tuple, n_rungs: int = 3) -> tuple:
    """Degradation ladder of fanout tuples: the configured fanouts, then
    repeated halvings (floor 1) until they bottom out or ``n_rungs`` is
    reached.  ((8, 4)) -> ((8, 4), (4, 2), (2, 1))."""
    rungs = [tuple(int(f) for f in fanouts)]
    while len(rungs) < n_rungs:
        nxt = tuple(max(f // 2, 1) for f in rungs[-1])
        if nxt == rungs[-1]:
            break
        rungs.append(nxt)
    return tuple(rungs)


class EgoNetSampler:
    """Per-rung NeighborSamplers sharing one graph + config."""

    def __init__(self, graph: graph_mod.Graph, cfg: gnn.GNNConfig,
                 rungs: tuple):
        if not rungs:
            raise ValueError("need at least one fanout rung")
        self.graph = graph
        self.cfg = cfg
        self.rungs = tuple(tuple(r) for r in rungs)
        self.samplers = [
            NeighborSampler(graph, batch_nodes=cfg.batch_nodes, fanouts=f,
                            method=cfg.reorder, block=cfg.comm_size,
                            seed=cfg.seed)
            for f in self.rungs]
        self._index = itertools.count()
        self._index_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.rungs)

    def max_seeds(self, rung: int) -> int:
        return self.samplers[rung].batch_nodes

    def pad_budget(self, rung: int) -> int:
        """Edge slots the padded payloads see at this rung: the sampler's
        edge budget plus one self-loop slot per node for GCN (mirrors
        train.gnn_steps.batch_edge_budget)."""
        s = self.samplers[rung]
        return s.edge_budget + (s.node_budget
                                if self.cfg.model == "gcn" else 0)

    def next_index(self) -> int:
        with self._index_lock:
            return next(self._index)

    def build(self, rung: int, seeds, index: int) -> SampledBatch:
        """Pure, thread-safe ego-net build: dedupe/validate the seeds into
        a ticket and run the rung sampler's fixed-budget padded build.
        Deterministic in (rung, seed set, index) — a retried build
        reproduces its batch bit-for-bit."""
        s = self.samplers[rung]
        return s.build(s.ego_ticket(seeds, index))
