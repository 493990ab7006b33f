"""Port parity: core/decompose.py (every registered payload), core/plan.py
and the fixed selector of core/gnn.py.  The reorder, the tier partition, the stats and every payload
array are host numpy in the reference, so the port must equal them."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools

import numpy as np
import pytest

from repro.core import decompose as RD
from repro.core import gnn as RGNN
from repro.core import plan as RP
from repro.graphs import graph as RG
from repro_torch.core import decompose as TD
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.core import plan as TP
from repro_torch.graphs import graph as TG

def _port_graph(g):
    return TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                    g.n_classes, g.name)


@functools.lru_cache(maxsize=None)
def _gcn_inputs(name, scale, comm):
    g = RG.add_self_loops(tp.ref_graph(name, scale, comm_size=comm))
    return g, RG.gcn_norm_values(g.n, g.senders, g.receivers)


@functools.lru_cache(maxsize=None)
def _pair(name="pubmed", scale=0.03, comm=8, k=1):
    """(reference, port) decompositions of one GCN-normalized graph."""
    g, vals = _gcn_inputs(name, scale, comm)
    ref = RD.decompose(g, comm_size=comm, method="bfs", edge_vals=vals,
                       inter_buckets=k)
    port = TD.decompose(_port_graph(g), comm_size=comm, method="bfs",
                        edge_vals=vals, inter_buckets=k, device="cpu")
    return ref, port


@pytest.mark.parametrize("name,scale,comm", [("citeseer", 0.02, 8),
                                             ("pubmed", 0.03, 16)])
def test_bfs_reorder_identical(name, scale, comm):
    g = tp.ref_graph(name, scale, comm_size=comm)
    tp.assert_bytes_equal(
        RD.bfs_reorder(g.n, g.senders, g.receivers, comm),
        TD.bfs_reorder(g.n, g.senders, g.receivers, comm))


@pytest.mark.parametrize("k", [1, 2])
def test_skeleton_tiers_identical(k):
    g, vals = _gcn_inputs("pubmed", 0.03, 8)
    ref = RD.decompose_skeleton(g, comm_size=8, edge_vals=vals,
                                inter_buckets=k)
    port = TD.decompose_skeleton(_port_graph(g), comm_size=8,
                                 edge_vals=vals, inter_buckets=k)
    assert (ref.n, ref.n_pad, ref.block_size) == (port.n, port.n_pad,
                                                  port.block_size)
    tp.assert_bytes_equal(ref.perm, port.perm)
    tp.assert_bytes_equal(ref.inv_perm, port.inv_perm)
    assert ref.stats == port.stats
    assert len(ref.tiers) == len(port.tiers) == k + 1
    for rt, pt in zip(ref.tiers, port.tiers):
        assert (rt.name, rt.kind, rt.stats) == (pt.name, pt.kind, pt.stats)
        for f in ("rows", "cols", "vals"):
            tp.assert_bytes_equal(getattr(rt, f), getattr(pt, f))


def test_materialized_payloads_identical():
    ref, port = _pair()
    tp.assert_bytes_equal(ref.perm, port.perm)
    tp.assert_bytes_equal(ref.inv_perm, port.inv_perm)
    assert [s.name for s in ref.subgraphs] == [s.name for s in port.subgraphs]
    for rs, ps in zip(ref.subgraphs, port.subgraphs):
        assert set(rs.formats) == set(ps.formats)
        assert rs.stats == ps.stats          # "kernels" names every spec
        for key, rp in rs.formats.items():
            pp = ps.formats[key]
            if not isinstance(rp, tuple):   # bell, tcgnn_tile are pairs
                rp, pp = (rp,), (pp,)
            assert len(rp) == len(pp)
            for rf, pf in zip(rp, pp):
                arrays = TF.ARRAY_FIELDS[type(pf)]
                for f in dataclasses.fields(pf):
                    if f.name in arrays:
                        tp.assert_bytes_equal(getattr(rf, f.name),
                                              getattr(pf, f.name))
                    else:
                        assert getattr(rf, f.name) == getattr(pf, f.name)


def test_plan_broadcasts_pair_over_inter_buckets():
    ref, port = _pair(k=2)
    assert len(port.subgraphs) == 3
    choice = ("block_diag", "bell")
    assert (TP.normalize_layer(port, choice)
            == RP.normalize_layer(ref, choice)
            == ("block_diag", "bell", "bell"))
    rplan = RP.KernelPlan.make(ref, choice, n_layers=2)
    pplan = TP.KernelPlan.make(port, choice, n_layers=2)
    assert (pplan.layers, pplan.subgraph_names) == (rplan.layers,
                                                    rplan.subgraph_names)
    assert TP.KernelPlan.make(port, pplan).layers == pplan.layers


@pytest.mark.parametrize("choice,exc", [
    (("block_diag", "nope"), KeyError),         # unknown kernel
    (("bell", "bell"), ValueError),             # bell on the diagonal tier
    (("block_diag", "bell", "coo"), ValueError),  # wrong arity
    ("block_diag", TypeError),                  # a name, not a sequence
])
def test_plan_rejects_bad_choices_like_the_reference(choice, exc):
    ref, port = _pair()
    with pytest.raises(exc):
        RP.normalize_layer(ref, choice)
    with pytest.raises(exc):
        TP.normalize_layer(port, choice)


def test_select_plan_fixed_matches_reference():
    ref, port = _pair()
    rplan, _ = RGNN.select_plan(ref, RGNN.GNNConfig(selector="fixed"),
                                [(32, 8), (8, 3)])
    pplan, probes = TGNN.select_plan(port, TGNN.GNNConfig(selector="fixed"),
                                     [(32, 8), (8, 3)])
    assert pplan.layers == rplan.layers and probes == {}


@pytest.mark.parametrize("cfg", [
    dict(model="gin"), dict(inter_buckets=0), dict(reorder="louvain")])
def test_unported_options_raise_naming_the_roadmap(cfg):
    g = _port_graph(tp.ref_graph())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TGNN.prepare(g, TGNN.GNNConfig(comm_size=8, **cfg), device="cpu")


def test_decomposed_to_moves_every_tensor():
    _, port = _pair()
    moved = port.to("cpu")
    assert moved.device.type == "cpu"
    for ps, ms in zip(port.subgraphs, moved.subgraphs):
        bell = ms.formats.get("bell")
        if bell is not None:
            tp.assert_bytes_equal(ps.formats["bell"][0].blocks,
                                  bell[0].blocks)
    assert np.array_equal(moved.perm.numpy(), port.perm.numpy())
