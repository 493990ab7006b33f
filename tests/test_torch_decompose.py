"""Port parity: core/decompose.py (both reorderers, every registered
payload, ``build_subgraph``, ``decomposition_quality``), core/louvain.py,
core/plan.py and the fixed selector of core/gnn.py.  The reorder, the tier
partition, the stats and every payload array are host numpy in the
reference, so the port must equal them."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import decompose as RD
from repro.core import gnn as RGNN
from repro.core import plan as RP
from repro.graphs import graph as RG
from repro_torch.core import adaptgear as TA
from repro_torch.core import decompose as TD
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.core import plan as TP
from repro_torch.graphs import graph as TG
from repro_torch.kernels.registry import OFFDIAG

SRC = Path(__file__).resolve().parents[1] / "src"


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


def _assert_subgraphs_equal(rs, ps) -> None:
    """Same name, kind, stats and payload arrays (bytes)."""
    assert (rs.name, rs.kind, rs.n_rows, rs.block_size) == (
        ps.name, ps.kind, ps.n_rows, ps.block_size)
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


def test_materialized_payloads_identical():
    ref, port = _pair()
    tp.assert_bytes_equal(ref.perm, port.perm)
    tp.assert_bytes_equal(ref.inv_perm, port.inv_perm)
    assert [s.name for s in ref.subgraphs] == [s.name for s in port.subgraphs]
    for rs, ps in zip(ref.subgraphs, port.subgraphs):
        _assert_subgraphs_equal(rs, ps)


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
    dict(sampler="cluster", prefetch_depth=2),
    dict(sampler="neighbor", checkpoint_dir="ckpt", checkpoint_every=1),
    dict(reorder="nope")])
def test_unported_options_raise_naming_the_roadmap(cfg, tmp_path):
    """The mini-batch path's asynchronous pipeline and checkpoints, ported
    now, run through ``gnn.train`` and give the sync run's losses, plans,
    hits and cache counters, never another path.  An unknown reorder
    method is a KeyError, as in the reference."""
    g = tp.ref_graph()
    if "reorder" in cfg:
        with pytest.raises(KeyError):
            RD.decompose_skeleton(g, comm_size=8, method=cfg["reorder"])
        with pytest.raises(KeyError):
            TGNN.prepare(_port_graph(g), TGNN.GNNConfig(comm_size=8, **cfg),
                         device="cpu")
        return
    if "checkpoint_dir" in cfg:
        cfg = dict(cfg, checkpoint_dir=str(tmp_path / cfg["checkpoint_dir"]))
    knob = TGNN.GNNConfig(comm_size=8, **cfg)
    sync = dataclasses.replace(knob, prefetch_depth=0, checkpoint_dir="",
                               checkpoint_every=0)
    got, want = (TGNN.train(_port_graph(g), c, steps=3, device="cpu")
                 for c in (knob, sync))
    assert got.losses == want.losses
    assert (got.plan_history, got.hit_history, got.cache, got.n_traces) == (
        want.plan_history, want.hit_history, want.cache, want.n_traces)
    assert (got.pipeline is not None) == (knob.prefetch_depth > 0)
    assert got.faults["checkpoints"] == (3 if knob.checkpoint_every else 0)


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


# --- Louvain (core/louvain.py) and the decomposition helpers ---------------

def _odd_graph():
    """60 nodes, the last 10 isolated, random edges among the first 50 with
    reversed duplicates of 40 of them and 8 self-loops."""
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 50, 200), rng.integers(0, 50, 200)
    loops = np.arange(0, 50, 7)
    return (60, np.concatenate([s, r[:40], loops]),
            np.concatenate([r, s[:40], loops]))


def _louvain_graph(name: str, comm: int):
    if name == "odd":
        return _odd_graph()
    g = tp.ref_graph(name, 0.1, comm_size=comm)
    return g.n, g.senders, g.receivers


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,comm", [("pubmed", 16), ("cora", 8),
                                       ("odd", 8), ("odd", 16)])
def test_louvain_reorder_identical(name, comm, seed):
    """The port's own Louvain gives the reference's (networkx's)
    permutation byte for byte, on the raw graph and with self-loops
    added, as GCN's prepare gives it."""
    n, snd, rcv = _louvain_graph(name, comm)
    loops = np.arange(n, dtype=snd.dtype)
    for s, r in ((snd, rcv), (np.concatenate([snd, loops]),
                              np.concatenate([rcv, loops]))):
        want = RD.louvain_reorder(n, s, r, comm, seed=seed)
        got = TD.louvain_reorder(n, s, r, comm, seed=seed)
        tp.assert_bytes_equal(want, got)
        assert sorted(got) == list(range(n))


def test_louvain_on_a_graph_without_edges_keeps_the_order():
    empty = np.zeros(0, np.int32)
    tp.assert_bytes_equal(RD.louvain_reorder(5, empty, empty, 8),
                          TD.louvain_reorder(5, empty, empty, 8))


def test_louvain_reorder_runs_without_networkx():
    """The port's Louvain imports no networkx: it runs with the module
    blocked, and nothing of networkx is loaded."""
    code = (
        "import sys\n"
        "sys.modules['networkx'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core import decompose\n"
        "s = np.array([0, 1, 2, 3, 4, 5], np.int32)\n"
        "r = np.array([1, 2, 0, 4, 5, 3], np.int32)\n"
        "perm = decompose.louvain_reorder(6, s, r, 4)\n"
        "assert sorted(perm.tolist()) == list(range(6)), perm\n"
        "assert sorted({int(perm[0]) // 3, int(perm[3]) // 3}) == [0, 1]\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not "
        "None and m.split('.')[0] in ('networkx', 'jax', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("method", ["louvain", "metis"])
def test_louvain_skeleton_identical(method, monkeypatch):
    """decompose_skeleton under louvain and under metis, which resolves
    to louvain with one warning per process and records the method it
    ran as ``stats["effective_method"]``, as the reference does."""
    monkeypatch.setattr(RD, "_warned_substitutions", set())
    monkeypatch.setattr(TD, "_warned_substitutions", set())
    g, vals = _gcn_inputs("pubmed", 0.03, 8)
    skels = []
    for mod, graph in ((RD, g), (TD, _port_graph(g))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            skels.append(mod.decompose_skeleton(
                graph, comm_size=8, method=method, edge_vals=vals))
            mod.decompose_skeleton(graph, comm_size=8, method=method,
                                   edge_vals=vals)
        subst = [w for w in caught if "substituting" in str(w.message)]
        assert len(subst) == (method == "metis")
    ref, port = skels
    assert port.stats["method"] == method
    assert port.stats["effective_method"] == "louvain"
    assert ref.stats == port.stats
    tp.assert_bytes_equal(ref.perm, port.perm)
    for rt, pt in zip(ref.tiers, port.tiers):
        assert (rt.name, rt.stats) == (pt.name, pt.stats)
        for f in ("rows", "cols", "vals"):
            tp.assert_bytes_equal(getattr(rt, f), getattr(pt, f))


def test_resolve_method_warns_once_per_method(monkeypatch):
    monkeypatch.setattr(TD, "_warned_substitutions", set())
    with pytest.warns(UserWarning, match="'metis'.*'louvain'"):
        assert TD.resolve_method("metis") == "louvain"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TD.resolve_method("metis") == "louvain"
        assert TD.resolve_method("bfs") == "bfs"
        assert TD.resolve_method("nope") == "nope"


def test_skeleton_without_reorder_keeps_node_order():
    g, vals = _gcn_inputs("pubmed", 0.03, 8)
    ref = RD.decompose_skeleton(g, comm_size=8, edge_vals=vals,
                                reorder=False)
    port = TD.decompose_skeleton(_port_graph(g), comm_size=8,
                                 edge_vals=vals, reorder=False)
    assert np.array_equal(port.perm, np.arange(g.n))
    tp.assert_bytes_equal(ref.perm, port.perm)
    assert ref.stats == port.stats


@pytest.mark.parametrize("tier,kernels", [
    (0, None), (1, None), (0, ("block_diag_fused",)),
    (1, ("bell_fused", "coo")), (1, ("block_diag",)), (0, ())])
def test_build_subgraph_identical(tier, kernels):
    """build_subgraph from one tier's edges: every payload, or those the
    names ask for (a fused name builds its unfused payload, a name that
    does not apply to the tier's kind builds nothing)."""
    g, vals = _gcn_inputs("pubmed", 0.03, 8)
    t = RD.decompose_skeleton(g, comm_size=8, edge_vals=vals).tiers[tier]
    n_pad = ((g.n + 7) // 8) * 8
    args = (t.name, t.kind, n_pad, 8, t.rows, t.cols, t.vals, kernels)
    ref = RD.build_subgraph(*args)
    port = TD.build_subgraph(*args, device="cpu")
    _assert_subgraphs_equal(ref, port)
    if kernels == ():
        assert port.formats == {} and port.stats["kernels"] == ()


def test_build_subgraph_refuses_an_edge_budget():
    """``build_subgraph(edge_budget=)`` (refused before the mini-batch
    path was ported) builds the reference's budget-capped payloads: the
    stats carry the budget, blocked-ELL and tcgnn are the capped triples,
    byte for byte, at a budget that spills and at one that does not."""
    g, vals = _gcn_inputs("pubmed", 0.03, 8)
    t = RD.decompose_skeleton(g, comm_size=8, edge_vals=vals).tiers[1]
    n_pad = ((g.n + 7) // 8) * 8
    for budget in (64, 10 ** 6):      # K = 1; K = every block column
        args = (t.name, OFFDIAG, n_pad, 8, t.rows, t.cols, t.vals, None,
                budget)
        ref = RD.build_subgraph(*args)
        port = TD.build_subgraph(*args, device="cpu")
        _assert_subgraphs_equal(ref, port)
        assert port.stats["edge_budget"] == budget
        for key in ("bell", "tcgnn_tile"):
            assert len(port.formats[key]) == 3
            assert port.formats[key][0].budgeted
        spill = port.formats["bell"][2].nnz
        assert (spill > 0) == (budget == 64)


@pytest.mark.parametrize("method,k", [("bfs", 1), ("louvain", 2)])
def test_decomposition_quality_identical(method, k):
    g, vals = _gcn_inputs("pubmed", 0.03, 8)
    ref = RD.decompose_skeleton(g, comm_size=8, method=method,
                                edge_vals=vals, inter_buckets=k)
    port = TD.decompose(_port_graph(g), comm_size=8, method=method,
                        edge_vals=vals, inter_buckets=k, device="cpu")
    want = RD.decomposition_quality(ref)
    assert TD.decomposition_quality(port) == want
    assert 0.0 < want["intra_frac"] < 1.0


@pytest.mark.parametrize("kernel", ["block_diag", "bell", "tcgnn_tile",
                                    "block_diag_fused"])
def test_full_static_rejects_a_kernel_that_misses_a_tier(kernel):
    """O1 runs one kernel on every tier, so a kernel that does not apply
    to every tier's kind is refused before anything runs, as in the
    reference (the plan layer's ValueError)."""
    ref, port = _pair()
    x = torch.zeros((port.n_pad, 4))
    with pytest.raises(ValueError):
        RP.normalize_layer(ref, (kernel,) * len(ref.subgraphs))
    with pytest.raises(ValueError):
        TA.aggregate_full_static(port, x, kernel)
