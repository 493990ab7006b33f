"""The port's training path on the CPU: the kernels' autograd Functions
(float64 gradcheck through the plain versions), fused and unfused GCN plans
against a dense-adjacency GCN, GIN under both structures against a
dense-adjacency GIN, the hand-written Adam against a numpy
transcription of the reference's formula, skipped dX passes, the fused
registry aliases, and ``train``'s contract.  The same training against
``repro.core.gnn.train`` is in tests/test_torch_jax_parity.py; the CUDA
kernels are checked on the card by tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import adaptgear as TA
from repro_torch.core import decompose as TD
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.core.plan import KernelPlan
from repro_torch.distributed import FaultPlan
from repro_torch.graphs import graph as TG
from repro_torch.kernels import ops
from repro_torch.kernels.registry import REGISTRY, KernelSpec
from repro_torch.train import gnn_steps
from repro_torch.weights import from_jax_params

PLANS = [("block_diag", "bell"), ("block_diag_fused", "bell_fused"),
         ("block_diag_fused", "bell"), ("block_diag", "bell_fused")]


@functools.lru_cache(maxsize=None)
def _graph():
    """A small pubmed-like graph, as the port's Graph."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    return TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                    g.n_classes, g.name)


@functools.lru_cache(maxsize=None)
def _prepared(k: int = 1):
    g = _graph()
    cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8, inter_buckets=k)
    return g, cfg, TGNN.prepare(g, cfg, device="cpu")


def _dense_adjacency(g) -> torch.Tensor:
    """Â with self-loops and the symmetric norm, assigned (not added) as
    the block formats store a duplicated self-loop once."""
    gl = TG.add_self_loops(g)
    vals = TG.gcn_norm_values(gl.n, gl.senders, gl.receivers)
    a = np.zeros((g.n, g.n), np.float32)
    a[gl.receivers, gl.senders] = vals
    return torch.from_numpy(a)


def _params(g, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [dict(w=rng.uniform(-0.4, 0.4, (fi, fo)).astype(np.float32),
                 b=rng.standard_normal(fo).astype(np.float32) * 0.1)
            for fi, fo in [(g.features.shape[1], 8), (8, g.n_classes)]]


def _bell_payload(B: int, seed: int, dtype=torch.float64, n: int = 48):
    r, c, v = tp.random_edges(n, 140, seed, block=B, spread=2)
    bell, bell_t = TF.to_device(
        (TF.coo_to_bell(TF.coo_from_edges(n, n, r, c, v), B),
         TF.coo_to_bell(TF.coo_from_edges(n, n, c, r, v), B)), tp.CPU)
    return (dataclasses.replace(bell, blocks=bell.blocks.to(dtype)),
            dataclasses.replace(bell_t, blocks=bell_t.blocks.to(dtype)))


@pytest.mark.parametrize("op", ["block_diag", "block_diag_acc", "bell",
                                "bell_acc", "block_diag_fused",
                                "block_diag_fused_acc", "bell_fused",
                                "bell_fused_acc"])
def test_autograd_functions_pass_gradcheck(op):
    """Each kernel Function's backward (transposed read, transpose
    payload, fused dX and the dW reduction) against finite differences, in
    float64 through the plain versions."""
    B, nb, Fi, Fo = 4, 12, 5, 3
    rng = np.random.default_rng(len(op))
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s)).requires_grad_()
    blocks = torch.from_numpy(rng.standard_normal((nb, B, B)))
    bell, bell_t = _bell_payload(B, seed=len(op))
    x, w = t(nb * B, Fi), t(Fi, Fo)
    fns = {
        "block_diag": (lambda x: ops.block_diag_matvec(blocks, x), (x,)),
        "block_diag_acc": (lambda x, y: ops.block_diag_matvec_acc(
            blocks, x, y), (x, t(nb * B, Fi))),
        "bell": (lambda x: ops.bell_matvec(bell, bell_t, x), (x,)),
        "bell_acc": (lambda x, y: ops.bell_matvec_acc(bell, bell_t, x, y),
                     (x, t(nb * B, Fi))),
        "block_diag_fused": (lambda x, w: ops.block_diag_fused_matvec(
            blocks, x, w), (x, w)),
        "block_diag_fused_acc": (lambda x, w, y:
                                 ops.block_diag_fused_matvec_acc(
                                     blocks, x, w, y), (x, w, t(nb * B, Fo))),
        "bell_fused": (lambda x, w: ops.bell_fused_matvec(
            bell, bell_t, x, w), (x, w)),
        "bell_fused_acc": (lambda x, w, y: ops.bell_fused_matvec_acc(
            bell, bell_t, x, w, y), (x, w, t(nb * B, Fo))),
    }
    fn, inputs = fns[op]
    assert torch.autograd.gradcheck(fn, inputs)


@pytest.mark.parametrize("plan", PLANS)
def test_gcn_plans_match_dense_gcn_fwd_and_grads(plan):
    """Two GCN layers through each plan (acc off and on) against the same
    layers over the dense adjacency: logits and every parameter's
    gradient, float32 1e-4."""
    g, cfg, dec = _prepared(k=2)
    a = _dense_adjacency(g)
    feats = torch.from_numpy(g.features)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (g.n, g.n_classes)).astype(np.float32))

    def dense(params):
        h = feats
        for i, p in enumerate(params):
            h = a @ (h @ p["w"]) + p["b"]
            if i == 0:
                h = torch.relu(h)
        return h

    want_p = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
              for p in _params(g)]
    want = dense(want_p)
    (want * cot).sum().backward()
    for acc in (False, True):
        got_p = [{k: torch.from_numpy(v).requires_grad_()
                  for k, v in p.items()} for p in _params(g)]
        x = TA.to_reordered(dec, feats)
        got = TA.from_reordered(dec, TGNN.forward(got_p, cfg, dec, x, plan,
                                                  acc=acc))
        tp.assert_close(want.detach(), got)
        (got * cot).sum().backward()
        for pw, pg in zip(want_p, got_p):
            for k in ("w", "b"):
                tp.assert_close(pw[k].grad, pg[k].grad)


def test_adam_update_matches_reference_formula():
    """The port's hand-written Adam against a numpy transcription of the
    reference's (repro/core/gnn.py _adam_update, float32 throughout), over
    several steps."""
    rng = np.random.default_rng(0)
    shapes = [(7, 4), (4,), (4, 3), (3,)]
    p_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    m_np = [np.zeros(s, np.float32) for s in shapes]
    v_np = [np.zeros(s, np.float32) for s in shapes]
    params = [dict(w=torch.from_numpy(p_np[0]), b=torch.from_numpy(p_np[1])),
              dict(w=torch.from_numpy(p_np[2]), b=torch.from_numpy(p_np[3]))]
    before = [{k: v.clone() for k, v in p.items()} for p in params]
    opt = TGNN._adam_init(params)
    lr, b1, b2, eps = np.float32(0.01), 0.9, 0.999, 1e-8
    new = params
    for t in range(1, 6):
        g_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        grads = [dict(w=torch.from_numpy(g_np[0]), b=torch.from_numpy(g_np[1])),
                 dict(w=torch.from_numpy(g_np[2]), b=torch.from_numpy(g_np[3]))]
        new, opt = TGNN._adam_update(new, grads, opt, float(lr))
        tf = np.float32(t)
        for i, g in enumerate(g_np):
            m_np[i] = np.float32(b1) * m_np[i] + np.float32(1 - b1) * g
            v_np[i] = np.float32(b2) * v_np[i] + np.float32(1 - b2) * g * g
            mh = m_np[i] / (np.float32(1) - np.float32(b1) ** tf)
            vh = v_np[i] / (np.float32(1) - np.float32(b2) ** tf)
            p_np[i] = p_np[i] - lr * mh / (np.sqrt(vh) + np.float32(eps))
        got = [new[0]["w"], new[0]["b"], new[1]["w"], new[1]["b"]]
        for want, have in zip(p_np, got):
            np.testing.assert_allclose(have.numpy(), want, atol=1e-6,
                                       rtol=1e-6)
    assert opt["t"] == 5
    for p, q in zip(params, before):               # inputs left as they were
        for k in p:
            assert torch.equal(p[k], q[k])


@pytest.mark.parametrize("fused", [False, True])
def test_dx_pass_runs_only_when_autograd_asks(monkeypatch, fused):
    """A layer's dX pass (the kernel over the transpose) runs only when its
    input needs a gradient: a first layer's raw features never do."""
    calls = []
    names = (["block_diag_spmm_fused", "bell_spmm_fused"] if fused
             else ["block_diag_spmm", "bell_spmm"])
    for name in names:
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("transpose", False), args[0].shape))
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    g, cfg, dec = _prepared()
    plan = PLANS[1] if fused else PLANS[0]
    x = TA.to_reordered(dec, torch.from_numpy(g.features))
    p = [{k: torch.from_numpy(v) for k, v in q.items()} for q in _params(g)]
    for needs in (False, True):
        xin = x.clone().requires_grad_(needs)
        w = p[0]["w"].clone().requires_grad_()
        y = TA.aggregate_transform(dec, xin, w, plan, bias=p[0]["b"])
        calls.clear()
        y.sum().backward()
        # fused: dX is the fused kernel again (2 calls, one per tier);
        # unfused: dH is needed for dW whatever x needs (2 calls)
        n_dx = len(calls)
        if fused:
            assert n_dx == (2 if needs else 0), calls
            assert (xin.grad is not None) == needs
        else:
            assert n_dx == 2, calls
        assert w.grad is not None


def test_fused_aliases_build_nothing_and_leave_payloads_unchanged(
        monkeypatch):
    """The fused specs alias the unfused payloads: decompose builds the
    same bytes with and without them registered, stores no payload under
    their names, and plans may name them."""
    g, cfg, _ = _prepared()
    gl = TG.add_self_loops(g)
    vals = TG.gcn_norm_values(gl.n, gl.senders, gl.receivers)
    with_fused = TD.decompose(gl, comm_size=8, edge_vals=vals, device="cpu")
    specs = dict(REGISTRY._specs)
    for name in ("block_diag_fused", "bell_fused"):
        assert specs[name].build is None and specs[name].fused
        assert specs[name].payload_key == specs[name].payload_of
    monkeypatch.setattr(REGISTRY, "_specs", {
        k: s for k, s in specs.items() if not s.fused})
    without = TD.decompose(gl, comm_size=8, edge_vals=vals, device="cpu")
    monkeypatch.setattr(REGISTRY, "_specs", specs)
    for a, b in zip(with_fused.subgraphs, without.subgraphs):
        assert set(a.formats) == set(b.formats)
        assert not {"block_diag_fused", "bell_fused"} & set(a.formats)
        for key, pa in a.formats.items():
            pa, pb = ((pa, b.formats[key]) if isinstance(pa, tuple)
                      else ((pa,), (b.formats[key],)))
            for fa, fb in zip(pa, pb):
                for f in TF.ARRAY_FIELDS[type(fa)]:
                    tp.assert_bytes_equal(getattr(fa, f), getattr(fb, f))
    plan = KernelPlan.make(with_fused, ("block_diag_fused", "bell_fused"),
                           n_layers=2)
    assert plan.layers[0] == ("block_diag_fused", "bell_fused")
    assert [s.name for s in REGISTRY.candidates("diag")
            if s.build is not None] == ["block_diag", "ell", "coo", "csr",
                                        "sell_cs"]
    assert "block_diag_fused" in [
        s.name for s in REGISTRY.candidates("diag", include_fused=True)]
    assert "block_diag_fused" not in [s.name for s in
                                      REGISTRY.candidates("diag")]


def test_registry_rejects_alias_of_unregistered_payload():
    with pytest.raises(ValueError, match="aliases unregistered payload"):
        REGISTRY.register(KernelSpec(
            name="nope_fused", kinds=frozenset({"diag"}), build=None,
            matvec=None, cost=None, payload_of="nope",
            fused_matvec=lambda p, x, w: x))
    assert "nope_fused" not in REGISTRY.names()


def test_aggregate_rejects_fused_kernels():
    g, cfg, dec = _prepared()
    x = TA.to_reordered(dec, torch.from_numpy(g.features))
    with pytest.raises(ValueError, match="needs a weight"):
        TA.aggregate(dec, x, ("block_diag_fused", "bell"))


def test_train_leaves_carried_params_untouched_and_learns():
    """train(params=from_jax_params(...)) starts from the given parameters,
    never writes into them, and lowers the loss; both plans give the same
    curve."""
    g = _graph()
    params = from_jax_params(_params(g), device="cpu")
    before = [{k: v.clone() for k, v in p.items()} for p in params]
    curves = {}
    for plan in PLANS[:2]:
        cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8,
                             selector="fixed", fixed_kernels=plan)
        res = TGNN.train(g, cfg, steps=4, device="cpu", params=params)
        assert res.kernels == [plan, plan]
        assert res.losses[-1] < res.losses[0]
        assert 0.0 <= res.accuracy <= 1.0
        curves[plan] = res.losses
    for p, q in zip(params, before):
        for k in p:
            assert torch.equal(p[k], q[k])
    np.testing.assert_allclose(curves[PLANS[1]], curves[PLANS[0]],
                               atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("field,value", [("sampler", "cluster"),
                                         ("sampler", "neighbor")])
def test_train_raises_for_unported_options(field, value, tmp_path):
    """Both samplers train; their one unported knob, injected kernel
    faults (kernel quarantine), raises NotImplementedError naming the
    ROADMAP item, never running another path instead.  Retries, ported
    now, run: ``retry_max=2`` with no fault gives the plain run's losses.
    ``resume_from``, ported too, runs: from a directory that holds no
    checkpoint it warns and trains afresh."""
    cfg = dataclasses.replace(TGNN.GNNConfig(hidden=8, comm_size=8),
                              **{field: value})
    retried = TGNN.train(_graph(), dataclasses.replace(cfg, retry_max=2),
                         steps=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP section 1 item 7"):
        gnn_steps.train_minibatch(_graph(), cfg, steps=1,
                                  fault_plan=FaultPlan(
                                      kernel_faults={"bell": "compile"}),
                                  device="cpu")
    fresh = TGNN.train(_graph(), cfg, steps=2, device="cpu")
    assert retried.losses == fresh.losses
    assert retried.faults["retries"] == 0
    with pytest.warns(UserWarning, match="no valid checkpoint"):
        res = TGNN.train(_graph(), dataclasses.replace(
            cfg, resume_from=str(tmp_path / "ckpt")), steps=2, device="cpu")
    assert res.losses == fresh.losses and res.faults["resumed_at"] == -1


# --- GIN ---------------------------------------------------------------------

GIN_PLANS = [("block_diag", "bell"), ("block_diag_fused", "tcgnn_tile_fused"),
             ("block_diag", "tcgnn_tile"), ("ell", "coo")]


@functools.lru_cache(maxsize=None)
def _gin_prepared(k: int = 2):
    g = _graph()
    cfg = TGNN.GNNConfig(model="gin", hidden=48, n_layers=2, comm_size=8,
                         inter_buckets=k)
    return g, cfg, TGNN.prepare(g, cfg, device="cpu")


def _gin_params(in_dim: int, hidden: int, n_classes: int, seed: int = 4):
    """Two GIN layers as numpy (the reference's layout), with a nonzero
    ``eps`` and biases so that every term shows in the checks."""
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)  # noqa: E731
    return [dict(eps=np.float32(rng.uniform(-0.2, 0.4)), w1=u(fi, hidden),
                 b1=u(hidden), w2=u(hidden, fo), b2=u(fo))
            for fi, fo in ((in_dim, hidden), (hidden, n_classes))]


def _dense_gin(a, feats, params):
    """GIN over the dense unit adjacency: MLP((1+eps) h + A h) per layer,
    ReLU between layers."""
    h = feats
    for i, p in enumerate(params):
        z = (1 + p["eps"]) * h + a @ h
        h = torch.relu(z @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


@pytest.mark.parametrize("structure", ["transform_first", "aggregate_first"])
@pytest.mark.parametrize("plan", GIN_PLANS)
def test_gin_plans_match_dense_gin_fwd_and_grads(plan, structure):
    """Two GIN layers through each plan, layer 1 forced to each structure
    through the plan's epilogues (a fused plan runs transform-first
    whatever it says), acc off and on, against the same model over the
    dense unit adjacency: logits and every parameter's gradient, ``eps``
    included, float32 1e-4."""
    from repro_torch.core import epilogue as TE
    g, cfg, dec = _gin_prepared()
    a = torch.zeros((g.n, g.n))
    a[torch.from_numpy(g.receivers).long(),
      torch.from_numpy(g.senders).long()] = 1.0
    feats = torch.from_numpy(g.features)
    in_dim = feats.shape[1]
    assert in_dim < cfg.hidden           # both structures are valid here
    eps = (TE.gin_layer_spec(in_dim, cfg.hidden, cfg.hidden, structure),
           TE.gin_layer_spec(cfg.hidden, cfg.hidden, g.n_classes,
                             "transform_first"))
    kplan = KernelPlan.make(dec, plan, n_layers=2, epilogues=eps)
    cot = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (g.n, g.n_classes)).astype(np.float32))
    params_np = _gin_params(in_dim, cfg.hidden, g.n_classes)
    leaves = lambda: [{k: torch.tensor(v).requires_grad_()  # noqa: E731
                       for k, v in p.items()} for p in params_np]
    want_p = leaves()
    want = _dense_gin(a, feats, want_p)
    (want * cot).sum().backward()
    x = TA.to_reordered(dec, feats)
    for acc in (False, True):
        got_p = leaves()
        got = TA.from_reordered(dec, TGNN.forward(got_p, cfg, dec, x, kplan,
                                                  acc=acc))
        tp.assert_close(want.detach(), got)
        (got * cot).sum().backward()
        for pw, pg in zip(want_p, got_p):
            assert set(pg) == {"eps", "w1", "b1", "w2", "b2"}
            for k in pw:
                tp.assert_close(pw[k].grad, pg[k].grad)


def test_gin_structures_aggregate_at_their_widths(monkeypatch):
    """Aggregate-first aggregates the raw features (F = in_dim, no
    transform reaches the kernels); transform-first aggregates X W1 at the
    hidden width, seeded by the self term (a full (n, hidden) y_in), with
    S = X W1 formed once and shared with the unfused kernels."""
    from repro_torch.core import epilogue as TE
    g, cfg, dec = _gin_prepared(k=1)
    widths, seeds = [], []
    real, real_acc = ops.block_diag_matvec, ops.block_diag_matvec_acc

    def spy(blocks, x):
        widths.append(x.shape[1])
        return real(blocks, x)

    def spy_acc(blocks, x, y):
        widths.append(x.shape[1])
        seeds.append(tuple(y.stride()))
        return real_acc(blocks, x, y)
    monkeypatch.setattr(ops, "block_diag_matvec", spy)
    monkeypatch.setattr(ops, "block_diag_matvec_acc", spy_acc)
    in_dim = g.features.shape[1]
    p = [{k: torch.tensor(v) for k, v in q.items()}
         for q in _gin_params(in_dim, cfg.hidden, g.n_classes)]
    x = TA.to_reordered(dec, torch.from_numpy(g.features))
    for structure, want in (("aggregate_first", in_dim),
                            ("transform_first", cfg.hidden)):
        widths.clear()
        seeds.clear()
        for acc in (False, True):
            TA.gin_conv(p[0], dec, x, ("block_diag", "bell"), structure,
                        acc=acc)
        assert widths == [want, want]
        assert seeds == ([(cfg.hidden, 1)] if structure == "transform_first"
                         else [])
    assert TE.gin_layer_spec(in_dim, cfg.hidden, 3,
                             "aggregate_first").hidden == cfg.hidden


def test_gin_train_prices_structure_learns_and_leaves_params():
    """train(model="gin") commits layer_plan_inputs(dec=...)'s structures
    on the plan, lowers the loss from carried parameters and writes into
    none of them; the feedback default probes layer 1 at its raw width
    (aggregate-first, no fused candidates) and layer 2 fused and
    unfused."""
    g, cfg, dec = _gin_prepared(k=1)
    in_dim = g.features.shape[1]
    params = from_jax_params(_gin_params(in_dim, cfg.hidden, g.n_classes),
                             device="cpu")
    before = [{k: v.clone() for k, v in p.items()} for p in params]
    pairs, eps = TGNN.layer_plan_inputs(cfg, in_dim, g.n_classes, dec=dec)
    fixed = dataclasses.replace(cfg, inter_buckets=1, selector="fixed",
                                fixed_kernels=("block_diag", "bell"))
    # sum aggregation makes GIN's first Adam step overshoot: the loss
    # rises at step 2 and falls below its start after a few more
    res = TGNN.train(g, fixed, steps=8, device="cpu", params=params)
    assert res.plan.epilogues == eps
    assert [e.structure for e in eps] == ["aggregate_first",
                                          "transform_first"]
    assert res.losses[-1] < res.losses[0]
    for p, q in zip(params, before):
        for k in p:
            assert torch.equal(p[k], q[k])
    fb = TGNN.train(g, dataclasses.replace(cfg, inter_buckets=1,
                                           warmup_iters=1),
                    steps=2, device="cpu", params=params)
    assert fb.plan.epilogues == eps and np.isfinite(fb.losses).all()
    assert {w for (_, _, w) in fb.probe_times} == {in_dim, cfg.hidden}
    fused = {k for (_, k, w) in fb.probe_times if REGISTRY.get(k).fused}
    assert fused and all(w == cfg.hidden for (_, k, w) in fb.probe_times
                         if k in fused)
