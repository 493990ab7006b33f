"""The port's GraphSAGE slice on the CPU: the mean normalization and the
SAGE decomposition against the reference's host arrays, the plain
dual-weight kernel against a dense product, its autograd Function (float64
gradcheck), the wrapper's CPU contract, the dual hook against the seed
path, the dual epilogue's cost and the cost-model plan against the
reference's, and SAGE parameters, forward and training.  Nothing here
makes JAX compile; the parity with the reference's Pallas kernels and
training is in tests/test_torch_jax_parity.py, the CUDA kernel on the card
in tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import epilogue as REP
from repro.core import gnn as RGNN
from repro.core import selector as RSEL
from repro.graphs import graph as RG
from repro_torch.core import adaptgear as TA
from repro_torch.core import decompose as TD
from repro_torch.core import epilogue as TE
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.core import selector as TSEL
from repro_torch.graphs import graph as TG
from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
from repro_torch.kernels import ops, ref
from repro_torch.weights import from_jax_params

DUAL_PLAN = ("block_diag_fused", "tcgnn_tile_fused")
SEED_PLAN = ("block_diag", "bell")
PAIRS = [(32, 8), (8, 3)]


def _port_graph(g):
    return TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                    g.n_classes, g.name)


def _cfg(**kw):
    return TGNN.GNNConfig(model="sage", hidden=8, comm_size=8, **kw)


@functools.lru_cache(maxsize=None)
def _pair(k: int = 1):
    """(reference, port) SAGE decompositions of one small graph."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    ref_dec = RGNN.prepare(g, RGNN.GNNConfig(model="sage", comm_size=8,
                                             inter_buckets=k))
    port_dec = TGNN.prepare(_port_graph(g), _cfg(inter_buckets=k),
                            device="cpu")
    return ref_dec, port_dec


def test_mean_norm_values_bytes_equal_the_reference():
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    tp.assert_bytes_equal(RG.mean_norm_values(g.n, g.senders, g.receivers),
                          TG.mean_norm_values(g.n, g.senders, g.receivers))
    # node 3 has no in-edge: its degree is clamped to 1, nothing divides by 0
    snd, rcv = np.array([0, 1, 2, 3], np.int32), np.array([1, 1, 2, 0],
                                                           np.int32)
    vals = TG.mean_norm_values(5, snd, rcv)
    tp.assert_bytes_equal(RG.mean_norm_values(5, snd, rcv), vals)
    assert vals.tolist() == [0.5, 0.5, 1.0, 1.0]


def test_sage_payloads_identical_to_the_reference():
    """No self-loops, 1/deg(dst) in the edge values: every payload array
    byte-identical to the reference's SAGE decomposition."""
    ref_dec, port_dec = _pair()
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    assert sum(s.stats["nnz"] for s in port_dec.subgraphs) == g.n_edges
    tp.assert_bytes_equal(ref_dec.perm, port_dec.perm)
    assert [s.name for s in ref_dec.subgraphs] == [
        s.name for s in port_dec.subgraphs]
    for rs, ps in zip(ref_dec.subgraphs, port_dec.subgraphs):
        assert rs.stats == ps.stats and set(rs.formats) == set(ps.formats)
        for key, rp in rs.formats.items():
            pp = ps.formats[key]
            rp, pp = (rp, pp) if isinstance(rp, tuple) else ((rp,), (pp,))
            for rf, pf in zip(rp, pp):
                for f in dataclasses.fields(pf):
                    if f.name in TF.ARRAY_FIELDS[type(pf)]:
                        tp.assert_bytes_equal(getattr(rf, f.name),
                                              getattr(pf, f.name))
                    else:
                        assert getattr(rf, f.name) == getattr(pf, f.name)


def _dual_inputs(B: int, nb: int, fi: int, fo: int, seed: int,
                 dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            for s in ((nb, B, B), (nb * B, fi), (fi, fo), (fi, fo),
                      (nb * B, fo))]


@pytest.mark.parametrize("B", [4, 8])
def test_dual_plain_matches_dense_and_function_passes_gradcheck(B):
    blocks, x, w, ws, y_in = _dual_inputs(B, 3, 5, 6, B)
    dense = torch.block_diag(*blocks)
    want = dense @ (x @ w) + x @ ws
    tp.assert_close(want.numpy(), ref.block_diag_spmm_dual(blocks, x, w, ws))
    tp.assert_close((want + y_in).numpy(),
                    ref.block_diag_spmm_dual(blocks, x, w, ws, y_in))
    args = [a.double().requires_grad_(i > 0)
            for i, a in enumerate(_dual_inputs(B, 2, 3, 2, B + 1))]
    assert torch.autograd.gradcheck(ops.block_diag_dual_matvec, args[:4])
    assert torch.autograd.gradcheck(ops.block_diag_dual_matvec_acc, args)


def test_dual_function_computes_only_the_grads_asked_for():
    blocks, x, w, ws, _ = _dual_inputs(8, 3, 5, 4, 7)
    w.requires_grad_()
    ws.requires_grad_()
    y = ops.block_diag_dual_matvec(blocks, x, w, ws)
    gw, gws = torch.autograd.grad(y.square().sum(), (w, ws))
    assert gw.dtype == gws.dtype == torch.float32
    assert x.grad is None


def test_dual_wrapper_cpu_contract_and_bad_operands():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; it raises on operands the kernel does not take."""
    blocks, x, w, ws, y_in = _dual_inputs(8, 3, 5, 4, 9)
    before = bdf_mod.dual_launches.value
    got = bdf_mod.block_diag_spmm_dual(blocks, x, w, ws, y_in)
    assert bdf_mod.dual_launches.value == before
    assert torch.equal(got, bdf_mod.plain_dual(blocks, x, w, ws, y_in))
    bad = [
        (blocks[0], x, w, ws, None),             # blocks not (nb, B, B)
        (blocks, x[:-1], w, ws, None),           # rows != nb * B
        (blocks, x, w[:-1], ws, None),           # w rows != Fi
        (blocks, x, w, ws[:, :-1], None),        # w_self shape != w's
        (blocks, x, w, ws, y_in[:, :-1]),        # y_in shape
        (blocks, x, w, ws.double(), None),       # mixed dtypes
    ]
    for args in bad:
        with pytest.raises(ValueError):
            bdf_mod.block_diag_spmm_dual(*args)


def test_dual_hook_matches_the_seed_path_and_bias_grad_is_n_pad():
    """aggregate_transform_dual with acc=True (the dual kernel on the
    diagonal tier) against acc=False (the dense self term seeding the
    accumulation), forward and grads, with and without the bias, at the
    reference's own tolerances (tests/test_epilogue.py, dual hook test)."""
    _, dec = _pair(2)
    names = ("block_diag_fused", "bell_fused", "bell_fused")
    rng = np.random.default_rng(3)
    xr, wn, ws, b = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((dec.n_pad, 5), (5, 7), (5, 7), (7,)))
    for bias in (b, None):
        outs = {}
        for acc in (True, False):
            leaves = [a.clone().requires_grad_() for a in (xr, wn, ws)]
            y = TA.aggregate_transform_dual(dec, *leaves, names, bias=bias,
                                            acc=acc)
            y.square().sum().backward()
            outs[acc] = (y.detach(), [a.grad for a in leaves])
        tp.assert_close(outs[False][0], outs[True][0], atol=1e-5, rtol=1e-5)
        for p, q in zip(outs[True][1], outs[False][1]):
            tp.assert_close(q, p, atol=1e-3, rtol=1e-3)
    bt = b.clone().requires_grad_()
    TA.aggregate_transform_dual(dec, xr, wn, ws, names, bias=bt,
                                acc=True).sum().backward()
    tp.assert_close(np.full((7,), dec.n_pad, np.float32), bt.grad,
                    atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("hw", ["cpu", "default"])
def test_dual_epilogue_cost_and_sage_plans_match_the_reference(hw):
    rhw, thw = {"cpu": (RSEL.CPU_HW, TSEL.CPU_HW),
                "default": (RSEL.HwModel(), TSEL.HwModel())}[hw]
    ref_eps = REP.layer_epilogues("sage", [32, 8, 3], 8)
    port_eps = TE.layer_epilogues("sage", [32, 8, 3], 8)
    for r, p in zip(ref_eps, port_eps):
        assert r == REP.EpilogueSpec(kind=p.kind, bias=p.bias,
                                     mean_norm=p.mean_norm)
        assert p == TE.EpilogueSpec("dual", mean_norm=True)
        for args in ((1000, 32, 8), (1000, None, 8), (19728, 500, 16)):
            assert (TE.epilogue_cost(p, *args, np.float32, thw)
                    == REP.epilogue_cost(r, *args, np.float32, rhw))
    assert TE.epilogue_cost(port_eps[0], 1000, 32, 8, torch.float32,
                            thw) > 0
    ref_dec, port_dec = _pair()
    for (fin, fout), r, p in zip(PAIRS, ref_eps, port_eps):
        assert (TSEL.plan_layer_cost(port_dec, fout, np.float32, thw, fin,
                                     epilogue=p)
                == RSEL.plan_layer_cost(ref_dec, fout, np.float32, rhw, fin,
                                        epilogue=r))
        assert (TSEL.select_by_cost_model(port_dec, fout, np.float32, thw,
                                          fin, epilogue=p)
                == RSEL.select_by_cost_model(ref_dec, fout, np.float32, rhw,
                                             fin, epilogue=r))
    rplan, _ = RGNN.select_plan(
        ref_dec, RGNN.GNNConfig(model="sage", selector="cost_model"), PAIRS,
        epilogues=ref_eps)
    pplan, _ = TGNN.select_plan(port_dec, _cfg(selector="cost_model"), PAIRS,
                                epilogues=port_eps)
    assert pplan.layers == rplan.layers


def test_sage_params_forward_and_carried_params():
    """init_model draws w_self before w_neigh per layer; the baked forward
    with the dual hook, the seed path and the legacy inv_deg form agree
    with an edge-list SAGE; from_jax_params takes SAGE layers."""
    g = _port_graph(tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32))
    cfg = _cfg(selector="fixed")
    params = TGNN.init_model(torch.Generator().manual_seed(0), cfg, 32,
                             g.n_classes, device="cpu")
    gen = torch.Generator().manual_seed(0)
    first = TA.init_sage_conv(gen, 32, 8, device="cpu")
    assert [list(p) for p in params] == [["w_self", "w_neigh", "b"]] * 2
    assert torch.equal(first["w_self"], params[0]["w_self"])
    assert torch.equal(first["w_neigh"], params[0]["w_neigh"])
    assert not torch.equal(params[0]["w_self"], params[0]["w_neigh"])
    params = [dict(p, b=torch.full_like(p["b"], 0.1)) for p in params]

    vals = TG.mean_norm_values(g.n, g.senders, g.receivers)
    snd, rcv = (torch.from_numpy(a.astype(np.int64))
                for a in (g.senders, g.receivers))
    h = torch.from_numpy(g.features)
    for i, p in enumerate(params):
        hn = (h @ p["w_neigh"])[snd] * torch.from_numpy(vals)[:, None]
        h = (h @ p["w_self"] + torch.zeros(g.n, hn.shape[1]).index_add_(
            0, rcv, hn) + p["b"])
        h = torch.relu(h) if i == 0 else h
    dec = TGNN.prepare(g, cfg, device="cpu")
    x = TA.to_reordered(dec, torch.from_numpy(g.features))
    for plan in (DUAL_PLAN, SEED_PLAN):
        for acc in (True, False):
            y = TGNN.forward(params, cfg, dec, x, plan, acc=acc)
            tp.assert_close(h, TA.from_reordered(dec, y))
    # the legacy form: unnormalized edge values, rows rescaled after
    raw = TD.decompose(g, comm_size=8, method="bfs",
                       edge_vals=np.ones(g.n_edges, np.float32),
                       inter_buckets=1, device="cpu")
    deg = np.bincount(g.receivers, minlength=g.n).astype(np.float32)
    inv_deg = TA.to_reordered(raw, torch.from_numpy(
        1.0 / np.maximum(deg, 1.0))[:, None])[:, 0]
    tp.assert_close(
        TA.sage_conv(params[0], dec, x, SEED_PLAN),
        TA.sage_conv(params[0], raw, x, SEED_PLAN, inv_deg=inv_deg))

    carried = from_jax_params([{k: v.numpy() for k, v in p.items()}
                               for p in params], device="cpu")
    for p, q in zip(params, carried):
        assert list(q) == list(p)
        for k in p:
            tp.assert_bytes_equal(p[k], q[k])
    bad = {"w_self": np.zeros((4, 3), np.float32),
           "w_neigh": np.zeros((4, 2), np.float32),
           "b": np.zeros(3, np.float32)}
    with pytest.raises(ValueError):
        from_jax_params([bad], device="cpu")
    with pytest.raises(ValueError):
        from_jax_params([dict(bad, extra=bad["b"])], device="cpu")


def test_sage_trains_by_feedback_and_fixed_plans_agree():
    """train(GNNConfig(model="sage")) selects by feedback on the CPU and
    lowers the loss; the dual and seed plans give the same curve."""
    g = _port_graph(tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32))
    res = TGNN.train(g, _cfg(warmup_iters=1), steps=3, device="cpu")
    assert res.plan.epilogues == (TE.EpilogueSpec("dual", mean_norm=True),) * 2
    assert len(res.probe_times) == 2 * (8 + 10)
    assert res.losses[-1] < res.losses[0]
    curves = [TGNN.train(g, _cfg(selector="fixed", fixed_kernels=plan),
                         steps=4, device="cpu").losses
              for plan in (DUAL_PLAN, SEED_PLAN)]
    assert curves[0][-1] < curves[0][0]
    np.testing.assert_allclose(curves[0], curves[1], atol=5e-3, rtol=1e-2)
