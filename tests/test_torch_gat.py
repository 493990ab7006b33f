"""The port's full-batch GAT, mean/max aggregation, bucket autotuning and
the small names of the reference that need no JAX, on the CPU: the graph
generators byte for byte (against the reference's numpy functions and
saved digests of their arrays), ``format_stats``, ``coo_spmm_dense_ref``,
``embed_lookup_onehot``, ``gat_conv`` against a dense-attention oracle
that knows nothing of the decomposition (isolated nodes included, no NaN
in the forward or the gradients), ``aggregate_max`` with tied maxima and
``aggregate_mean`` against edge-list references.  The same functions
against ``repro.core`` are in tests/test_torch_jax_parity.py; the card
runs them in tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch

from repro.graphs import graph as RG
from repro_torch.core import adaptgear as TA
from repro_torch.core import epilogue as TE
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.graphs import graph as TG
from repro_torch.kernels import ref as TREF
from repro_torch.layers import nn as TNN
from repro_torch.weights import from_jax_params

# sha256 (first 16 hex digits) of src.tobytes() + dst.tobytes() of the
# reference's generators (repro/graphs/graph.py), and the edge counts
GENERATOR_CASES = {
    ("rmat", (500, 2000, 0)): ("f88613563fee3433", 2000),
    ("rmat", (1000, 6000, 3)): ("a1315362e6d63fcb", 6000),
    ("aligned_community_graph", (1024, 4000, 128, 0.9, 0)):
        ("a7eb577305a7932a", 3941),
    ("aligned_community_graph", (700, 3000, 64, 0.75, 2)):
        ("b1cf82625852fe6d", 2938),
}


@pytest.mark.parametrize("name,args", list(GENERATOR_CASES))
def test_generators_match_the_reference_byte_for_byte(name, args):
    src, dst = getattr(TG, name)(*args)
    rsrc, rdst = getattr(RG, name)(*args)
    tp.assert_bytes_equal(rsrc, src)
    tp.assert_bytes_equal(rdst, dst)
    digest = hashlib.sha256(src.tobytes() + dst.tobytes()).hexdigest()[:16]
    assert (digest, len(src)) == GENERATOR_CASES[(name, args)]
    assert src.dtype == dst.dtype == np.int32
    n = args[0]
    assert len(np.unique(src.astype(np.int64) * n + dst)) == len(src)
    assert src.min() >= 0 and max(src.max(), dst.max()) < n


def test_aligned_community_graph_keeps_its_blocks():
    """Intra edges stay in their diagonal block; inter edges go from block
    b + 1 to block b (the ring)."""
    n, block = 1024, 128
    src, dst = TG.aligned_community_graph(n, 4000, block, 0.9, seed=0)
    same = src // block == dst // block
    assert 0.85 < same.mean() < 0.95
    nb = n // block
    assert ((src[~same] // block) == (dst[~same] // block + 1) % nb).all()


def _formats():
    rows = np.array([0, 0, 1, 3, 5, 6, 7, 7], np.int32)
    cols = np.array([1, 4, 1, 2, 5, 0, 6, 7], np.int32)
    vals = np.arange(1, 9, dtype=np.float32)
    coo = TF.coo_from_edges(8, 8, rows, cols, vals)
    return coo, rows, cols, vals


def test_format_stats_reads_every_format():
    from repro_torch.kernels.registry import _bell_build
    coo, rows, cols, _ = _formats()
    assert TF.format_stats(coo) == dict(kind="coo", nnz=8, n=8,
                                        density=8 / 64)
    assert TF.format_stats(TF.coo_to_csr(coo)) == dict(kind="csr", nnz=8,
                                                       n=8)
    ell = TF.coo_to_ell(coo)
    assert TF.format_stats(ell) == dict(kind="ell", n=8, max_deg=2,
                                        padded=16)
    on = rows // 4 == cols // 4
    bd = TF.coo_to_blockdiag(TF.coo_from_edges(8, 8, rows[on], cols[on]), 4)
    assert TF.format_stats(bd) == dict(kind="block_diag", n_blocks=2,
                                       block_size=4, density=on.sum() / 32)
    placed = TF.to_device(bd, tp.CPU)
    assert TF.format_stats(placed) == TF.format_stats(bd)
    bell, _ = _bell_build(coo, TF.coo_from_edges(8, 8, cols, rows), 4, {})
    assert TF.format_stats(bell) == dict(
        kind="bell", n_brow=bell.n_rows // bell.block_size,
        max_blocks=bell.max_blocks, block_size=bell.block_size)
    with pytest.raises(TypeError):
        TF.format_stats((coo,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coo_spmm_dense_ref_adds_duplicates(dtype):
    _, rows, cols, vals = _formats()
    rows = np.concatenate([rows, rows[:2]])     # two duplicated edges
    cols = np.concatenate([cols, cols[:2]])
    vals = np.concatenate([vals, vals[:2]])
    x = np.random.default_rng(0).standard_normal((8, 5)).astype(np.float32)
    a = np.zeros((8, 8), np.float32)
    np.add.at(a, (rows, cols), vals)
    tx = torch.from_numpy(x).to(dtype)
    got = TREF.coo_spmm_dense_ref(*(torch.from_numpy(t) for t in
                                    (rows, cols, vals)), tx, 8)
    assert got.dtype == dtype
    want = a @ tx.float().numpy()
    tol = tp.F32_TOL if dtype == torch.float32 else dict(atol=2e-1, rtol=3e-1)
    tp.assert_close(want, got.float(), **tol)
    edge = TREF.coo_spmm(*(torch.from_numpy(t) for t in (rows, cols, vals)),
                         tx, 8)
    tp.assert_close(edge.float(), got.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_lookup_onehot_equals_the_gather(dtype):
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((37, 12), generator=gen).to(dtype)
    ids = torch.randint(0, 37, (3, 9), generator=gen, dtype=torch.int32)
    got = TNN.embed_lookup_onehot(table, ids)
    assert got.dtype == dtype and tuple(got.shape) == (3, 9, 12)
    assert torch.equal(got, TNN.embed_lookup(table, ids))


# --- GAT and the mean / max aggregators ------------------------------------

@functools.lru_cache(maxsize=None)
def _graph_with_isolated():
    """A small pubmed-like graph where every 37th node has no in-edge and
    six nodes at the end have no edge at all."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    keep = g.receivers % 37 != 0
    n = g.n + 6
    feats = np.concatenate([g.features, np.random.default_rng(1).normal(
        size=(6, g.features.shape[1])).astype(np.float32)])
    labels = np.concatenate([g.labels, np.zeros(6, np.int32)])
    return TG.Graph(n, g.senders[keep], g.receivers[keep], feats, labels,
                    g.n_classes, "isolated")


@functools.lru_cache(maxsize=None)
def _gat_prepared(k: int):
    g = _graph_with_isolated()
    cfg = TGNN.GNNConfig(model="gat", hidden=8, n_layers=2, comm_size=8,
                         inter_buckets=k, selector="fixed")
    return g, cfg, TGNN.prepare(g, cfg, device="cpu")


def _gat_layer(fin: int, fout: int, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return dict(w=rng.uniform(-0.5, 0.5, (fin, fout)).astype(np.float32),
                a_dst=rng.uniform(-1, 1, fout).astype(np.float32),
                a_src=rng.uniform(-1, 1, fout).astype(np.float32),
                b=rng.standard_normal(fout).astype(np.float32) * 0.1)


def _dense_gat(g, p: dict, x: torch.Tensor, slope: float = 0.2):
    """Independent oracle in original node order: dense logits over the
    adjacency, a masked row softmax, a row with no in-edge giving ``b``."""
    adj = torch.zeros((g.n, g.n), dtype=torch.bool)
    adj[torch.from_numpy(g.receivers).long(),
        torch.from_numpy(g.senders).long()] = True
    h = x @ p["w"]
    e = torch.nn.functional.leaky_relu(
        (h @ p["a_dst"])[:, None] + (h @ p["a_src"])[None, :], slope)
    e = e.masked_fill(~adj, -torch.inf)
    has = adj.any(1, keepdim=True)
    att = torch.where(has, torch.softmax(torch.where(has, e, 0.0), dim=1),
                      0.0)
    return att @ h + p["b"]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_gat_conv_matches_a_dense_oracle_with_isolated_nodes(k):
    """gat_conv over the decomposition against the dense-attention GAT in
    original order: outputs and the gradients of every parameter and of x
    within float64 1e-10 (the port runs float64 inputs through the same
    ops), no NaN anywhere, and rows with no in-edge equal to ``b``."""
    g, _, dec = _gat_prepared(k)
    assert len(dec.subgraphs) - 1 == len(dec.inter_edges_i64)
    p = {key: torch.from_numpy(v).double()
         for key, v in _gat_layer(g.features.shape[1], 8).items()}
    feats = torch.from_numpy(g.features).double()
    cot = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (g.n, 8)))
    got_p = {key: v.clone().requires_grad_() for key, v in p.items()}
    got_x = feats.clone().requires_grad_()
    y = TA.from_reordered(dec, TA.gat_conv(
        got_p, dec, TA.to_reordered(dec, got_x)))
    (y * cot).sum().backward()
    want_p = {key: v.clone().requires_grad_() for key, v in p.items()}
    want_x = feats.clone().requires_grad_()
    want = _dense_gat(g, want_p, want_x)
    (want * cot).sum().backward()
    torch.testing.assert_close(y, want, atol=1e-10, rtol=1e-10)
    for key in p:
        assert torch.isfinite(got_p[key].grad).all()
        torch.testing.assert_close(got_p[key].grad, want_p[key].grad,
                                   atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(got_x.grad, want_x.grad, atol=1e-10,
                               rtol=1e-10)
    lonely = np.setdiff1d(np.arange(g.n), g.receivers)
    assert len(lonely) >= 6
    torch.testing.assert_close(y[lonely].detach(),
                               p["b"].expand(len(lonely), -1))


def test_gat_trains_through_every_selector_and_learns():
    """GNNConfig(model="gat") trains: the loss falls over 6 steps, the
    curve does not depend on the plan (GAT reads the edges, not the plan;
    the selector still commits one, as in the reference), and the plan's
    epilogues are None."""
    g, cfg, _ = _gat_prepared(2)
    params = [_gat_layer(g.features.shape[1], 8, 3),
              _gat_layer(8, g.n_classes, 4)]
    tparams = from_jax_params(params, device="cpu")
    curves = {}
    for sel in ("fixed", "cost_model", "feedback"):
        c = dataclasses.replace(cfg, selector=sel, warmup_iters=1)
        res = TGNN.train(g, c, steps=6, device="cpu", params=tparams)
        assert res.plan.epilogues == (None, None)
        assert np.isfinite(res.losses).all()
        assert res.losses[-1] < res.losses[0]
        curves[sel] = res.losses
        if sel == "feedback":
            assert {w for (_, _, w) in res.probe_times} == {
                g.features.shape[1], 8}
    np.testing.assert_allclose(curves["feedback"], curves["fixed"],
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(curves["cost_model"], curves["fixed"],
                               atol=1e-6, rtol=1e-6)


def test_gat_params_init_carry_and_width_pairs():
    cfg = TGNN.GNNConfig(model="gat", hidden=8, n_layers=3)
    params = TGNN.init_model(torch.Generator().manual_seed(0), cfg, 5, 3,
                             device="cpu")
    assert [{k: tuple(v.shape) for k, v in p.items()} for p in params] == [
        dict(w=(5, 8), a_dst=(8,), a_src=(8,), b=(8,)),
        dict(w=(8, 8), a_dst=(8,), a_src=(8,), b=(8,)),
        dict(w=(8, 3), a_dst=(3,), a_src=(3,), b=(3,))]
    assert TGNN.agg_width_pairs(cfg, 5, 3) == [(None, 5), (None, 8),
                                               (None, 8)]
    assert TGNN.layer_epilogues(cfg, 5, 3) == (None,) * 3
    assert TE.layer_epilogues("gat", [5, 8, 3], 8) == (None, None)
    carried = from_jax_params([{k: v.numpy() for k, v in p.items()}
                               for p in params], device="cpu")
    for p, q in zip(params, carried):
        for k in p:
            assert torch.equal(p[k], q[k])
    bad = {k: v.numpy() for k, v in params[0].items()}
    bad["a_src"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="a_src"):
        from_jax_params([bad], device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        TGNN.init_model(torch.Generator(), dataclasses.replace(
            cfg, model="nope"), 5, 3, device="cpu")


def _edge_lists(dec):
    """Every tier's COO edges (rows, cols, vals), concatenated."""
    parts = [s.formats["coo"] for s in dec.subgraphs]
    return tuple(torch.cat([getattr(c, f).long() if f != "vals"
                            else c.vals for c in parts])
                 for f in ("rows", "cols", "vals"))


@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag", "tcgnn_tile"),
                                  ("ell", "coo")])
def test_aggregate_mean_matches_an_edge_list_mean(plan):
    g, _, dec = _gat_prepared(2)
    rows, cols, _ = _edge_lists(dec)
    deg = torch.bincount(rows, minlength=dec.n_pad).float()
    inv_deg = 1.0 / deg.clamp(min=1.0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (dec.n_pad, 6)).astype(np.float32))
    want = torch.zeros_like(x).index_add_(0, rows, x[cols]) * inv_deg[:, None]
    names = (plan[0],) + (plan[1],) * (len(dec.subgraphs) - 1)
    for acc in (False, True):
        got = TA.aggregate_mean(dec, x, inv_deg, names, acc=acc)
        tp.assert_close(want, got)


def test_aggregate_max_splits_gradients_among_ties():
    """Integer-valued features make ties: the max over in-neighbours equals
    a dense masked max (0 where a row has none), and its gradient gives
    each (row, feature) a total of one, shared by the maximizing
    in-neighbours only."""
    g, _, dec = _gat_prepared(2)
    rows, cols, _ = _edge_lists(dec)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-2, 3, (dec.n_pad, 5)).astype(
        np.float32)).requires_grad_()
    y = TA.aggregate_max(dec, x)
    adj = torch.zeros((dec.n_pad, dec.n_pad), dtype=torch.bool)
    adj[rows, cols] = True
    dense = torch.where(adj[:, :, None], x.detach()[None, :, :], -torch.inf)
    want = torch.amax(dense, dim=1)
    want = torch.where(torch.isfinite(want), want, 0.0)
    torch.testing.assert_close(y.detach(), want, atol=0, rtol=0)
    assert (dense == want[:, None, :]).sum(1).max() > 1      # ties happen
    y.sum().backward()
    grad = x.grad
    has = adj.any(1)
    assert float(grad.sum()) == pytest.approx(float(has.sum()) * 5)
    is_max = (dense == want[:, None, :]) & adj[:, :, None]
    hit = is_max.any(0)                    # (n_pad, F): a maximizer somewhere
    assert (grad[~hit] == 0).all()
    assert (grad >= 0).all()


@pytest.mark.parametrize("model", ["gcn", "gin", "gat"])
def test_bucket_autotune_commits_the_cheapest_count(model):
    g = _graph_with_isolated()
    cfg = TGNN.GNNConfig(model=model, hidden=8, comm_size=8,
                         inter_buckets=0)
    dec = TGNN.prepare(g, cfg, device="cpu")
    totals = dec.stats["bucket_autotune"]
    assert set(totals) == {1, 2, 4}
    best = min(totals, key=totals.get)
    fixed = TGNN.prepare(g, dataclasses.replace(cfg, inter_buckets=best),
                         device="cpu")
    assert len(dec.subgraphs) == len(fixed.subgraphs)
    assert dec.stats["inter_buckets"] == fixed.stats["inter_buckets"]
    for a, b in zip(dec.subgraphs, fixed.subgraphs):
        assert a.stats == b.stats
