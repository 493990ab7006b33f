"""Louvain community detection, without networkx.

The reference reorders with ``networkx.community.louvain_communities``
(``repro/core/decompose.py`` ``louvain_reorder``).  This module is a copy
of that method from networkx 3.6.1 (``algorithms/community/louvain.py``:
``louvain_communities``, ``louvain_partitions``, ``_one_level``,
``_neighbor_weights``, ``_gen_graph``; ``algorithms/community/quality.py``:
``modularity``), cut to what the reorder asks for: an undirected simple
graph with unit weights, ``resolution=1``, ``threshold=1e-7`` and an int
seed, which networkx turns into ``random.Random(seed)`` and shuffles with.
At resolution 1 and integer weights (every weight here is a sum of unit
weights) dropping networkx's ``resolution *`` factors changes no float.
The port therefore needs no networkx, and its permutation is the
reference's byte for byte.

What decides the partition is the order of iteration, so the copy keeps
networkx's:

* adjacency dicts in insertion order, as ``nx.Graph`` builds them from
  ``add_nodes_from(range(n))`` then ``add_edges_from(zip(senders,
  receivers))``: a duplicate or reversed pair keeps its first slot, a
  self-loop is one entry of its node's dict and counts twice in the
  weighted degree;
* edges walked as ``Graph.edges`` walks them (nodes in order, each
  node's neighbours in insertion order, skipping the nodes already
  walked), for the weighted copy, ``_gen_graph`` and ``modularity``;
* ``weights2com`` a ``defaultdict`` whose ties go to the first inserted
  community (a strict ``>`` on the gain), the sums of floats in networkx's
  order, and Python's own ``sum``.

The networkx notice, as its licence asks:

    Copyright (c) 2004-2025, NetworkX Developers
    Aric Hagberg <hagberg@lanl.gov>
    Dan Schult <dschult@colgate.edu>
    Pieter Swart <swart@lanl.gov>
    All rights reserved.

    Redistribution and use in source and binary forms, with or without
    modification, are permitted provided that the following conditions are
    met:

      * Redistributions of source code must retain the above copyright
        notice, this list of conditions and the following disclaimer.

      * Redistributions in binary form must reproduce the above
        copyright notice, this list of conditions and the following
        disclaimer in the documentation and/or other materials provided
        with the distribution.

      * Neither the name of the NetworkX Developers nor the names of its
        contributors may be used to endorse or promote products derived
        from this software without specific prior written permission.

    THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
    "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
    LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
    A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
    OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
    SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT
    LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE,
    DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY
    THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT
    (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE
    OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""
from __future__ import annotations

import random
from collections import defaultdict, deque
from dataclasses import dataclass

import numpy as np


@dataclass
class WGraph:
    """An undirected weighted graph on nodes ``0 .. len(adj) - 1``:
    ``adj[u]`` maps each neighbour to the edge's weight, in insertion
    order (a self-loop is ``adj[u][u]``).  ``nodes[u]`` is the set of
    original nodes that node ``u`` stands for (networkx's ``"nodes"`` node
    attribute), None on the input graph, where it is ``{u}``."""
    adj: list
    nodes: list | None = None

    def members(self, u: int) -> set:
        return self.nodes[u] if self.nodes is not None else {u}

    def add_edge(self, u: int, v: int, w) -> None:
        # nx.Graph.add_edge: an existing pair keeps its slot in both dicts
        self.adj[u][v] = w
        self.adj[v][u] = w

    def edges(self, nbunch=None):
        """``(u, v, w)`` per edge, once, as ``Graph.edges(nbunch,
        data="weight")`` yields them."""
        seen = {}
        for u in (range(len(self.adj)) if nbunch is None else nbunch):
            for v, w in self.adj[u].items():
                if v not in seen:
                    yield u, v, w
            seen[u] = 1

    def degrees(self) -> list:
        """Weighted degrees, a self-loop counted twice."""
        return [sum(nbrs.values()) + (u in nbrs and nbrs[u])
                for u, nbrs in enumerate(self.adj)]

    def size(self) -> float:
        return sum(self.degrees()) / 2


def graph_from_edges(n: int, senders: np.ndarray,
                     receivers: np.ndarray) -> WGraph:
    """``nx.Graph()``, ``add_nodes_from(range(n))``, ``add_edges_from(zip(
    senders, receivers))``, with the unit weights the reorder reads."""
    g = WGraph([{} for _ in range(n)])
    for u, v in zip(senders.tolist(), receivers.tolist()):
        g.add_edge(u, v, 1)
    return g


THRESHOLD = 0.0000001   # networkx's default modularity gain per level


def modularity(G: WGraph, communities) -> float:
    """``nx.community.modularity(G, communities, weight="weight")`` for an
    undirected graph."""
    degree = G.degrees()
    deg_sum = sum(degree)
    m = deg_sum / 2
    norm = 1 / deg_sum**2

    def community_contribution(community):
        comm = set(community)
        L_c = sum(wt for u, v, wt in G.edges(comm) if v in comm)
        degree_sum = sum(degree[u] for u in comm)
        return L_c / m - degree_sum * degree_sum * norm

    return sum(map(community_contribution, communities))


def louvain_communities(G: WGraph, seed: int = 0) -> list:
    """The final partition of :func:`louvain_partitions` (a list of sets
    of nodes)."""
    partitions = louvain_partitions(G, random.Random(seed))
    final_partition = deque(partitions, maxlen=1)
    return final_partition.pop()


def louvain_partitions(G: WGraph, seed: random.Random):
    """Yield the partition of each level of the Louvain method."""
    partition = [{u} for u in range(len(G.adj))]
    if not any(G.adj):
        yield partition
        return
    mod = modularity(G, partition)
    graph = WGraph([{} for _ in G.adj])
    for u, v, w in G.edges():
        graph.add_edge(u, v, w)

    m = graph.size()
    partition, inner_partition, improvement = _one_level(
        graph, m, partition, seed
    )
    improvement = True
    while improvement:
        yield [s.copy() for s in partition]
        new_mod = modularity(graph, inner_partition)
        if new_mod - mod <= THRESHOLD:
            return
        mod = new_mod
        graph = _gen_graph(graph, inner_partition)
        partition, inner_partition, improvement = _one_level(
            graph, m, partition, seed
        )


def _one_level(G: WGraph, m, partition, seed: random.Random):
    """One level of the Louvain partitions tree (the undirected branch)."""
    n = len(G.adj)
    node2com = list(range(n))
    inner_partition = [{u} for u in range(n)]
    degrees = G.degrees()
    Stot = list(degrees)
    nbrs = [{v: wt for v, wt in G.adj[u].items() if v != u}
            for u in range(n)]
    rand_nodes = list(range(n))
    seed.shuffle(rand_nodes)
    nb_moves = 1
    improvement = False
    while nb_moves > 0:
        nb_moves = 0
        for u in rand_nodes:
            best_mod = 0
            best_com = node2com[u]
            weights2com = _neighbor_weights(nbrs[u], node2com)
            degree = degrees[u]
            Stot[best_com] -= degree
            remove_cost = -weights2com[best_com] / m + (
                Stot[best_com] * degree
            ) / (2 * m**2)
            for nbr_com, wt in weights2com.items():
                gain = (
                    remove_cost
                    + wt / m
                    - (Stot[nbr_com] * degree) / (2 * m**2)
                )
                if gain > best_mod:
                    best_mod = gain
                    best_com = nbr_com
            Stot[best_com] += degree
            if best_com != node2com[u]:
                com = G.members(u)
                partition[node2com[u]].difference_update(com)
                inner_partition[node2com[u]].remove(u)
                partition[best_com].update(com)
                inner_partition[best_com].add(u)
                improvement = True
                nb_moves += 1
                node2com[u] = best_com
    partition = list(filter(len, partition))
    inner_partition = list(filter(len, inner_partition))
    return partition, inner_partition, improvement


def _neighbor_weights(nbrs, node2com):
    """Weights between a node and its neighbour communities."""
    weights = defaultdict(float)
    for nbr, wt in nbrs.items():
        weights[node2com[nbr]] += wt
    return weights


def _gen_graph(G: WGraph, partition) -> WGraph:
    """The graph of the communities of ``partition``."""
    H = WGraph([{} for _ in partition], [])
    node2com = {}
    for i, part in enumerate(partition):
        nodes = set()
        for node in part:
            node2com[node] = i
            nodes.update(G.members(node))
        H.nodes.append(nodes)

    for node1, node2, wt in G.edges():
        com1 = node2com[node1]
        com2 = node2com[node2]
        temp = H.adj[com1].get(com2, 0)
        H.add_edge(com1, com2, wt + temp)
    return H
