"""Port parity of the selectors on the CPU: the registry's candidate order,
every spec's cost, the cost-model plans and the feedback selector's
commitments against the reference's (host Python in both packages, so
exact or rel 1e-12), and ``select_plan``/``train`` with the paper's
feedback default on the CPU.  Nothing here makes JAX compile."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import decompose as RD
from repro.core import epilogue as REP
from repro.core import gnn as RGNN
from repro.core import selector as RSEL
from repro.graphs import graph as RG
from repro.kernels.registry import REGISTRY as RREG
from repro_torch.core import adaptgear as TA
from repro_torch.core import decompose as TD
from repro_torch.core import epilogue as TE
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.core import selector as TSEL
from repro_torch.core.plan import KernelPlan
from repro_torch.graphs import graph as TG
from repro_torch.kernels import registry as TR
from repro_torch.kernels.registry import REGISTRY

PAIRS = [(32, 8), (8, 3)]
HWS = {"cpu": (RSEL.CPU_HW, TSEL.CPU_HW), "default": (RSEL.HwModel(),
                                                        TSEL.HwModel())}


def _port_graph(g):
    return TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                    g.n_classes, g.name)


@functools.lru_cache(maxsize=None)
def _pair(k: int = 2):
    """(reference, port) decompositions of one GCN-normalized graph."""
    g = RG.add_self_loops(tp.ref_graph("pubmed", 0.03, comm_size=8))
    vals = RG.gcn_norm_values(g.n, g.senders, g.receivers)
    ref = RD.decompose(g, comm_size=8, method="bfs", edge_vals=vals,
                       inter_buckets=k)
    port = TD.decompose(_port_graph(g), comm_size=8, method="bfs",
                        edge_vals=vals, inter_buckets=k, device="cpu")
    return ref, port


def _rel_close(a: float, b: float) -> None:
    assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (a, b)


@pytest.mark.parametrize("kind", ["diag", "offdiag"])
@pytest.mark.parametrize("include_fused", [False, True])
def test_candidates_follow_the_reference_order(kind, include_fused):
    assert REGISTRY.names() == RREG.names()
    want = [s.name for s in RREG.candidates(kind, include_fused)]
    assert [s.name for s in REGISTRY.candidates(kind, include_fused)] == want
    ref, port = _pair()
    for rs, ps in zip(ref.subgraphs, port.subgraphs):
        assert ([s.name for s in REGISTRY.candidates_for(ps, include_fused)]
                == [s.name for s in RREG.candidates_for(rs, include_fused)])


@pytest.mark.parametrize("hw", sorted(HWS))
def test_every_cost_matches_the_reference(hw):
    """Every registered spec on every subgraph, unfused at both layer
    widths and fused at both width pairs, within rel 1e-12."""
    rhw, thw = HWS[hw]
    ref, port = _pair()
    n = 0
    for rs, ps in zip(ref.subgraphs, port.subgraphs):
        for spec in REGISTRY.candidates_for(ps, include_fused=True):
            for fin, fout in PAIRS:
                in_dim = fin if spec.fused else None
                _rel_close(
                    RSEL.candidate_cost(rs, spec.name, fout, np.float32, rhw,
                                        in_dim, 1e-6),
                    TSEL.candidate_cost(ps, spec.name, fout, np.float32, thw,
                                        in_dim, 1e-6))
                n += 1
    assert n == 2 * (8 + 2 * 10)           # diag 8, two inter tiers of 10
    for fin, fout in PAIRS:
        _rel_close(RSEL.dense_transform_cost(500, fin, fout, np.float32, rhw),
                   TSEL.dense_transform_cost(500, fin, fout, np.float32, thw))
        for in_dim in (None, fin):
            _rel_close(RSEL.plan_layer_cost(ref, fout, np.float32, rhw,
                                            in_dim),
                       TSEL.plan_layer_cost(port, fout, np.float32, thw,
                                            in_dim))


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("k", [1, 2])
def test_cost_model_plans_match_the_reference(hw, k):
    rhw, thw = HWS[hw]
    ref, port = _pair(k)
    for fin, fout in PAIRS + [(500, 16), (16, 3)]:
        for in_dim in (None, fin):
            assert (TSEL.select_by_cost_model(port, fout, np.float32, thw,
                                              in_dim)
                    == RSEL.select_by_cost_model(ref, fout, np.float32, rhw,
                                                 in_dim))


def test_select_plan_cost_model_matches_the_reference():
    ref, port = _pair()
    rplan, _ = RGNN.select_plan(ref, RGNN.GNNConfig(selector="cost_model"),
                                PAIRS)
    pplan, probes = TGNN.select_plan(
        port, TGNN.GNNConfig(selector="cost_model"), PAIRS)
    assert pplan.layers == rplan.layers and probes == {}


@pytest.mark.parametrize("include_fused", [False, True])
def test_adaptive_selector_commits_like_the_reference(include_fused):
    """Both selectors fed the same observed times: the same readiness, the
    same commitments (nearest width included), and before any
    observation the same cost-model fallback."""
    ref, port = _pair()
    rsel = RSEL.AdaptiveSelector(ref, warmup_iters=2,
                                 include_fused=include_fused)
    psel = TSEL.AdaptiveSelector(port, warmup_iters=2,
                                 include_fused=include_fused)
    for width in [(32, 8), 3]:
        assert psel.choice(width) == rsel.choice(width)      # fallback
    rng = np.random.default_rng(0)
    for width in [(32, 8), (8, 3)]:
        for it in range(2):
            for rs in ref.subgraphs:
                for spec in RREG.candidates_for(rs, include_fused):
                    t = float(rng.uniform(1e-4, 1e-3))
                    rsel.observe(rs.name, spec.name, t, width)
                    psel.observe(rs.name, spec.name, t, width)
            assert psel.ready(width) == rsel.ready(width) == (it == 1)
    for width in [(32, 8), (8, 3), (30, 8), 3, (0, 9)]:
        assert psel.choice(width) == rsel.choice(width)


def test_default_hw_follows_the_device():
    assert TSEL.default_hw("cpu") == TSEL.CPU_HW
    h100 = TSEL.default_hw(torch.device("cuda", 0))
    assert h100 is TSEL.H100_HW
    assert (h100.peak_flops, h100.hbm_bw) == (67e12, 3.35e12)
    assert h100.mxu_eff(16) == h100.mxu_eff(64) == 1.0
    assert TSEL.HwModel().mxu_eff(16) == RSEL.HwModel().mxu_eff(16) == 0.125
    for f in ("peak_flops", "hbm_bw", "launch_overhead_s", "gather_eff",
              "scatter_eff"):
        assert getattr(TSEL.CPU_HW, f) == getattr(RSEL.CPU_HW, f)


def test_feedback_select_plan_on_cpu_commits_the_probed_argmin():
    """select_plan("feedback") times every candidate of every subgraph at
    each width pair and commits the per-subgraph argmin of those times."""
    _, port = _pair()
    cfg = TGNN.GNNConfig(warmup_iters=1)
    assert cfg.selector == "feedback"
    eps = TE.layer_epilogues("gcn", [32, 8, 3], 8)
    plan, probes = TGNN.select_plan(port, cfg, PAIRS, epilogues=eps)
    assert isinstance(plan, KernelPlan) and plan.epilogues == eps
    assert KernelPlan.make(port, plan).layers == plan.layers   # valid
    for (fin, fout), layer in zip(PAIRS, plan.layers):
        for sub, name in zip(port.subgraphs, layer):
            cands = [s.name for s in REGISTRY.candidates_for(
                sub, include_fused=True)]
            times = {k: probes[(sub.name, k, fout)] for k in cands}
            assert name == min(cands, key=times.get)
    assert len(probes) == 2 * (8 + 2 * 10)


def test_train_selects_by_feedback_by_default():
    g = _port_graph(tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32))
    cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8)
    res = TGNN.train(g, cfg, steps=2, device="cpu")
    assert len(res.probe_times) == 2 * (8 + 10)
    assert res.kernels == [tuple(k) for k in res.plan.layers]
    assert res.plan.epilogues == (TE.EpilogueSpec("linear"),) * 2
    assert np.isfinite(res.losses).all()
    for (_, fout), layer in zip(PAIRS, res.plan.layers):
        for sub, name in zip(("intra", "inter"), layer):
            assert (sub, name, fout) in res.probe_times


def test_epilogues_and_aggregate_sub():
    assert TE.layer_epilogues("gcn", [5, 4, 3], 4) == (
        TE.EpilogueSpec("linear"),) * 2
    assert TE.epilogue_cost(TE.EpilogueSpec("linear"), 10, 5, 4,
                            hw=TSEL.CPU_HW) == 0.0
    assert TE.layer_epilogues("gat", [5, 4, 3], 4) == (None, None)
    # budget-capped blocked-ELL (the mini-batch payload): the triple
    coo = TF.coo_from_edges(16, 16, [0], [9], [1.0])
    bell, bell_t, spill = TR._bell_build(coo, None, 8, {"edge_budget": 64})
    assert bell.budgeted and bell_t.budgeted and spill.nnz == 0
    assert int(bell.n_valid.sum()) == int(bell_t.n_valid.sum()) == 1
    for mod, hw in ((TE, TSEL.CPU_HW), (REP, RSEL.CPU_HW)):
        with pytest.raises(ValueError, match="unknown epilogue kind"):
            mod.epilogue_cost(mod.EpilogueSpec("nope"), 10, 5, 4, hw=hw)
    _, port = _pair()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (port.n_pad, 4)).astype(np.float32))
    w = torch.eye(4)
    want = TA.aggregate(port, x, ("block_diag", "bell"))
    # the intra tier keeps block_diag: coo-like formats add both copies of
    # a self-loop that add_self_loops duplicated, the block formats one
    got = sum(TA.aggregate_sub(s, x, k) for s, k in
              zip(port.subgraphs, ("block_diag", "csr", "tcgnn_tile")))
    tp.assert_close(want, got)
    got = sum(TA.aggregate_sub_fused(s, x, w, k) for s, k in
              zip(port.subgraphs, ("block_diag_fused", "sell_fused",
                                   "tcgnn_tile_fused")))
    tp.assert_close(want, got)
    with pytest.raises(ValueError, match="fused"):
        TA.aggregate_sub(port.intra, x, "block_diag_fused")
    with pytest.raises(ValueError, match="not fused"):
        TA.aggregate_sub_fused(port.intra, x, w, "block_diag")


# --- GIN's MLP epilogue ------------------------------------------------------

GIN_SPECS = [(6, 8, 3), (32, 64, 7), (16, 16, 3)]   # (fin, hidden, out)


def _spec_fields(spec) -> tuple:
    return (spec.kind, spec.bias, spec.activation, spec.mean_norm,
            spec.out_dim, spec.structure, spec.hidden, spec.free_transform)


@pytest.mark.parametrize("fin,hidden,out", GIN_SPECS)
def test_gin_epilogue_specs_match_the_reference(fin, hidden, out):
    """GIN's EpilogueSpecs field for field, ``free_transform`` included:
    only a transform-first MLP layer shares its transform (S = X W1) with
    the unfused candidates; an aggregate-first one aggregates raw
    features, as in the reference."""
    for structure in ("transform_first", "aggregate_first"):
        got = TE.gin_layer_spec(fin, hidden, out, structure)
        want = REP.gin_layer_spec(fin, hidden, out, structure)
        assert _spec_fields(got) == _spec_fields(want)
        assert got.free_transform == (structure == "transform_first")
    assert _spec_fields(TE.EpilogueSpec("mlp")) == _spec_fields(
        REP.EpilogueSpec("mlp"))
    got = TE.gin_structure_candidates(fin, hidden, out)
    want = REP.gin_structure_candidates(fin, hidden, out)
    assert [(p, _spec_fields(e)) for p, e in got] == [
        (p, _spec_fields(e)) for p, e in want]
    dims = [fin, hidden, out]
    assert ([_spec_fields(e) for e in TE.layer_epilogues("gin", dims,
                                                         hidden)]
            == [_spec_fields(e) for e in REP.layer_epilogues("gin", dims,
                                                             hidden)])
    for hw in sorted(HWS):
        rhw, thw = HWS[hw]
        for (pair, te), (_, re) in zip(got, want):
            for n, f_in in ((500, pair[0]), (500, fin), (64, None)):
                _rel_close(REP.epilogue_cost(re, n, f_in, pair[1],
                                             np.float32, rhw),
                           TE.epilogue_cost(te, n, f_in, pair[1],
                                            np.float32, thw))


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("structure", ["transform_first", "aggregate_first"])
def test_gin_layer_costs_and_plans_match_the_reference(hw, structure):
    """plan_layer_cost and select_by_cost_model on GIN specs, with and
    without an in_dim: an aggregate-first spec charges the unfused
    candidates their share of a transform, a transform-first one does
    not (the port waived it under both structures before)."""
    rhw, thw = HWS[hw]
    for k in (1, 2):
        ref, port = _pair(k)
        for fin, hidden, out in GIN_SPECS:
            te = TE.gin_layer_spec(fin, hidden, out, structure)
            re = REP.gin_layer_spec(fin, hidden, out, structure)
            for feat, in_dim in ((hidden, fin), (fin, None), (hidden, None)):
                _rel_close(RSEL.plan_layer_cost(ref, feat, np.float32, rhw,
                                                in_dim, re),
                           TSEL.plan_layer_cost(port, feat, np.float32, thw,
                                                in_dim, te))
                assert (TSEL.select_by_cost_model(port, feat, np.float32,
                                                  thw, in_dim, te)
                        == RSEL.select_by_cost_model(ref, feat, np.float32,
                                                     rhw, in_dim, re))
            _rel_close(RSEL._transform_share(ref, hidden, np.float32, rhw,
                                             fin, re),
                       TSEL._transform_share(port, hidden, np.float32, thw,
                                             fin, te))


@functools.lru_cache(maxsize=None)
def _gin_pair(feat: int, k: int):
    """(reference, port) decompositions as GIN prepares them: no
    self-loops, unit values."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=feat)
    rcfg = RGNN.GNNConfig(model="gin", comm_size=8, inter_buckets=k)
    tcfg = TGNN.GNNConfig(model="gin", comm_size=8, inter_buckets=k)
    return (g, RGNN.prepare(g, rcfg),
            TGNN.prepare(_port_graph(g), tcfg, device="cpu"))


@pytest.mark.parametrize("hw", sorted(HWS))
@pytest.mark.parametrize("feat,hidden,n_layers,k", [
    (6, 8, 2, 1), (32, 64, 3, 2), (32, 16, 2, 1), (8, 64, 2, 2)])
def test_gin_layer_plan_inputs_price_like_the_reference(hw, feat, hidden,
                                                        n_layers, k):
    """layer_plan_inputs(dec=...) commits the reference's pair and
    structure per layer (priced where the hidden width exceeds the input
    width), and without a decomposition takes the same width rule."""
    rhw, thw = HWS[hw]
    g, ref, port = _gin_pair(feat, k)
    rcfg = RGNN.GNNConfig(model="gin", hidden=hidden, n_layers=n_layers,
                          comm_size=8, inter_buckets=k)
    tcfg = TGNN.GNNConfig(model="gin", hidden=hidden, n_layers=n_layers,
                          comm_size=8, inter_buckets=k)
    in_dim = g.features.shape[1]
    for dec_r, dec_t in ((None, None), (ref, port)):
        rp, re = RGNN.layer_plan_inputs(rcfg, in_dim, g.n_classes, dec=dec_r,
                                        hw=rhw)
        tpairs, teps = TGNN.layer_plan_inputs(tcfg, in_dim, g.n_classes,
                                              dec=dec_t, hw=thw)
        assert [tuple(p) for p in tpairs] == [tuple(p) for p in rp]
        assert [_spec_fields(e) for e in teps] == [_spec_fields(e)
                                                   for e in re]
    assert TGNN.agg_widths(tcfg, in_dim, g.n_classes) == RGNN.agg_widths(
        rcfg, in_dim, g.n_classes)
    # the cost-model plan under those inputs
    rplan, _ = RGNN.select_plan(
        ref, dataclasses.replace(rcfg, selector="cost_model"), rp,
        epilogues=re)
    tplan, _ = TGNN.select_plan(
        port, dataclasses.replace(tcfg, selector="cost_model"), tpairs,
        epilogues=teps)
    assert tplan.layers == rplan.layers
