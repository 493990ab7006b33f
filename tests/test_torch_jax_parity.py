"""Port parity against the JAX reference where the reference compiles:
the kernel modules (the reference's ``ops.*_matvec(_acc)`` and
``tcgnn_tile.*_matvec(_acc)`` run the Pallas kernels in interpret mode on
the CPU; ``csr``/``sell_cs`` are XLA there) and the whole slice
(``repro.core.gnn.forward`` and ``train`` from the reference's own
parameters).
Float32 tolerance atol = rtol = 1e-4, the reference's own
(tests/test_fused.py).

This file holds every port test that makes JAX compile, as a few tests
that each loop over their cases.  Few tests put the file at the end of
pytest-xdist's ``--dist loadfile`` queue (largest files first), so its JAX
compiles do not share the CPU with the early, load-sensitive files of the
suite.  The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.core import adaptgear as RA
from repro.core import formats as RF
from repro.core import gnn as RGNN
from repro.kernels import ops as ROPS
from repro_torch.core import adaptgear as TA
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.graphs import graph as TG
from repro_torch.kernels import ops
from repro_torch.weights import from_jax_params

PLAN = ("block_diag", "bell")


def test_block_diag_plain_matches_pallas_kernel():
    for B, F in [(8, 13), (16, 24)]:
        rng = np.random.default_rng(B + F)
        blocks = rng.standard_normal((4, B, B)).astype(np.float32)
        x = rng.standard_normal((4 * B, F)).astype(np.float32)
        y_in = rng.standard_normal((4 * B, F)).astype(np.float32)
        ref = ROPS.block_diag_matvec(jnp.asarray(blocks), jnp.asarray(x))
        port = ops.block_diag_matvec(torch.from_numpy(blocks),
                                     torch.from_numpy(x))
        assert tuple(port.shape) == (4 * B, F)
        tp.assert_close(ref, port)
        ref = ROPS.block_diag_matvec_acc(jnp.asarray(blocks), jnp.asarray(x),
                                         jnp.asarray(y_in))
        port = ops.block_diag_matvec_acc(torch.from_numpy(blocks),
                                         torch.from_numpy(x),
                                         torch.from_numpy(y_in))
        tp.assert_close(ref, port)


def test_bell_plain_matches_pallas_kernel():
    n = 96
    for B, F in [(8, 5), (16, 24)]:
        r, c, v = tp.random_edges(n, 260, 3 * B + F, block=B, spread=2)
        ref_p = (RF.coo_to_bell(RF.coo_from_edges(n, n, r, c, v), B),
                 RF.coo_to_bell(RF.coo_from_edges(n, n, c, r, v), B))
        port_p = TF.to_device(
            (TF.coo_to_bell(TF.coo_from_edges(n, n, r, c, v), B),
             TF.coo_to_bell(TF.coo_from_edges(n, n, c, r, v), B)), tp.CPU)
        assert int(port_p[0].n_valid.min()) < port_p[0].max_blocks  # padded
        rng = np.random.default_rng(B)
        x = rng.standard_normal((ref_p[0].n_cols, F)).astype(np.float32)
        y_in = rng.standard_normal((ref_p[0].n_rows, F)).astype(np.float32)
        tp.assert_close(ROPS.bell_matvec(*ref_p, jnp.asarray(x)),
                        ops.bell_matvec(*port_p, torch.from_numpy(x)))
        tp.assert_close(
            ROPS.bell_matvec_acc(*ref_p, jnp.asarray(x), jnp.asarray(y_in)),
            ops.bell_matvec_acc(*port_p, torch.from_numpy(x),
                                torch.from_numpy(y_in)))


def test_ell_and_coo_match_reference():
    n = 64
    r, c, v = tp.random_edges(n, 180, 11)
    x = np.random.default_rng(12).standard_normal((n, 7)).astype(np.float32)
    ref_coo = RF.coo_from_edges(n, n, r, c, v)
    port_coo = TF.coo_from_edges(n, n, r, c, v)
    tp.assert_close(ROPS.coo_matvec(ref_coo, jnp.asarray(x)),
                    ops.coo_matvec(TF.to_device(port_coo, tp.CPU),
                                   torch.from_numpy(x)))
    tp.assert_close(ROPS.ell_matvec(RF.coo_to_ell(ref_coo), jnp.asarray(x)),
                    ops.ell_matvec(TF.to_device(TF.coo_to_ell(port_coo),
                                                tp.CPU), torch.from_numpy(x)))


def _reference_gcn():
    """The reference prepared on a small pubmed-like graph, with its own
    parameters (as numpy) and logits."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    cfg = RGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8, selector="fixed")
    dec = RGNN.prepare(g, cfg)
    params = RGNN.init_model(jax.random.PRNGKey(0), cfg,
                             g.features.shape[1], g.n_classes)
    params_np = [{k: np.asarray(a) for k, a in p.items()} for p in params]
    x = RA.to_reordered(dec, jnp.asarray(g.features))
    return g, params_np, np.asarray(RGNN.forward(params, cfg, dec, x, PLAN))


def test_gcn_forward_matches_reference_from_carried_params():
    g, params_np, ref_logits = _reference_gcn()
    params = from_jax_params(params_np, device="cpu")
    for p, q in zip(params_np, params):          # carried over exactly
        for key in ("w", "b"):
            tp.assert_bytes_equal(p[key], q[key])
    cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8)
    port_g = TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                      g.n_classes, g.name)
    dec = TGNN.prepare(port_g, cfg, device="cpu")
    x = TA.to_reordered(dec, torch.from_numpy(g.features))
    for acc in (False, True):
        logits = TGNN.forward(params, cfg, dec, x, PLAN, acc=acc)
        assert tuple(logits.shape) == ref_logits.shape == (dec.n_pad, 3)
        assert bool(torch.isfinite(logits).all())
        tp.assert_close(ref_logits, logits)


def test_fused_and_unfused_grads_match_reference_custom_vjps():
    """A @ (X W) + b through the port's fused and unfused plans, in both
    accumulation modes, against the reference's aggregate_transform
    differentiated by jax.grad through its custom_vjps (Pallas kernels in
    interpret mode): outputs and dx, dW, db."""
    from repro.core import decompose as RD
    from repro.graphs import graph as RG
    from repro_torch.core import decompose as TD
    n = 180
    r, c, v = tp.random_edges(n, 1400, 0)
    args = (n, c, r, np.zeros((n, 3), np.float32), np.zeros(n, np.int32), 2)
    ref_dec = RD.decompose(RG.Graph(*args), comm_size=8, method="bfs",
                           edge_vals=v, inter_buckets=2)
    port_dec = TD.decompose(TG.Graph(*args), comm_size=8, method="bfs",
                            edge_vals=v, inter_buckets=2, device="cpu")
    rng = np.random.default_rng(1)
    x, w, b, cot = (rng.standard_normal(s).astype(np.float32)
                    for s in ((n, 5), (5, 7), (7,), (n, 7)))
    for plan in (PLAN, ("block_diag_fused", "bell_fused")):
        for acc in (False, True):
            def ref_loss(x, w, b):
                y = RA.aggregate_transform(ref_dec, RA.to_reordered(
                    ref_dec, x), w, plan, bias=b, acc=acc)
                return jnp.sum(RA.from_reordered(ref_dec, y) * cot)

            ref_y = RA.from_reordered(ref_dec, RA.aggregate_transform(
                ref_dec, RA.to_reordered(ref_dec, jnp.asarray(x)),
                jnp.asarray(w), plan, bias=jnp.asarray(b), acc=acc))
            ref_g = jax.grad(ref_loss, argnums=(0, 1, 2))(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
            xt, wt, bt = (torch.from_numpy(a).requires_grad_()
                          for a in (x, w, b))
            port_y = TA.from_reordered(port_dec, TA.aggregate_transform(
                port_dec, TA.to_reordered(port_dec, xt), wt, plan, bias=bt,
                acc=acc))
            (port_y * torch.from_numpy(cot)).sum().backward()
            tp.assert_close(ref_y, port_y)
            for rg, pg in zip(ref_g, (xt.grad, wt.grad, bt.grad)):
                tp.assert_close(rg, pg)


def test_training_curves_match_reference_from_its_params():
    """The port's train from the reference's own initial parameters
    (init_model(PRNGKey(cfg.seed)), carried by from_jax_params) against
    repro.core.gnn.train, both plans, 5 steps; the curve tolerance is the
    reference's own for this comparison (tests/test_fused.py)."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    port_g = TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                      g.n_classes, g.name)
    for plan in (PLAN, ("block_diag_fused", "bell_fused")):
        ref_cfg = RGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8,
                                 selector="fixed", fixed_kernels=plan)
        ref = RGNN.train(g, ref_cfg, steps=5)
        params = RGNN.init_model(jax.random.PRNGKey(ref_cfg.seed), ref_cfg,
                                 g.features.shape[1], g.n_classes)
        params_np = [{k: np.asarray(a) for k, a in p.items()} for p in params]
        cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8,
                             selector="fixed", fixed_kernels=plan)
        port = TGNN.train(port_g, cfg, steps=5, device="cpu",
                          params=from_jax_params(params_np, device="cpu"))
        assert port.kernels == [tuple(k) for k in ref.kernels]
        np.testing.assert_allclose(port.losses, ref.losses, atol=5e-3,
                                   rtol=1e-2)


BF16_TOL = dict(atol=2e-1, rtol=3e-1)       # tests/test_fused.py


def _grads_ref(fn, args, cot):
    """Output and input gradients of sum(fn(*args) * cot) in JAX."""
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * cot),
                     argnums=tuple(range(len(args))))(*args)
    return out, grads


def _grads_port(fn, args, cot):
    leaves = [a.clone().requires_grad_() for a in args]
    out = fn(*leaves)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, [a.grad for a in leaves]


def test_tcgnn_matvecs_match_reference_custom_vjps():
    """tcgnn_matvec(_acc) and tcgnn_fused_matvec(_acc): outputs and the
    gradients of every input (x, w, y_in) against jax.grad through the
    reference's custom VJPs (Pallas interpret mode), float32 at 1e-4 and
    bfloat16 at atol 2e-1 / rtol 3e-1."""
    from repro.kernels import tcgnn_tile as RT
    from repro_torch.kernels import tcgnn_tile as TT
    n, B = 64, 8
    r, c, v = tp.random_edges(n, 300, 21, block=B, spread=2)
    ref_p = RT._tcgnn_build(RF.coo_from_edges(n, n, r, c, v),
                            RF.coo_from_edges(n, n, c, r, v), B, {})
    port_p = TF.to_device(TT._tcgnn_build(
        TF.coo_from_edges(n, n, r, c, v), TF.coo_from_edges(n, n, c, r, v),
        B, {}), tp.CPU)
    rng = np.random.default_rng(22)
    x, w, h, y_in, cot = (rng.standard_normal(s).astype(np.float32) for s in
                          ((n, 5), (5, 3), (n, 3), (n, 3), (n, 3)))
    cases = {
        "mv": (lambda h: RT.tcgnn_matvec(*ref_p, h),
               lambda h: TT.tcgnn_matvec(*port_p, h), (h,)),
        "mv_acc": (lambda h, y: RT.tcgnn_matvec_acc(*ref_p, h, y),
                   lambda h, y: TT.tcgnn_matvec_acc(*port_p, h, y),
                   (h, y_in)),
        "fmv": (lambda x, w: RT.tcgnn_fused_matvec(*ref_p, x, w),
                lambda x, w: TT.tcgnn_fused_matvec(*port_p, x, w), (x, w)),
        "fmv_acc": (lambda x, w, y: RT.tcgnn_fused_matvec_acc(*ref_p, x, w,
                                                              y),
                    lambda x, w, y: TT.tcgnn_fused_matvec_acc(*port_p, x, w,
                                                              y),
                    (x, w, y_in)),
    }
    for jdt, tdt, tol in ((jnp.float32, torch.float32, tp.F32_TOL),
                          (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        for name, (rfn, pfn, args) in cases.items():
            ref_y, ref_g = _grads_ref(
                rfn, [jnp.asarray(a).astype(jdt) for a in args], cot)
            port_y, port_g = _grads_port(
                pfn, [torch.from_numpy(a).to(tdt) for a in args], cot)
            assert port_y.dtype == tdt, name
            tp.assert_close(np.asarray(ref_y, np.float32), port_y.float(),
                            **tol)
            for rg, pg in zip(ref_g, port_g):
                tp.assert_close(np.asarray(rg, np.float32), pg.float(), **tol)


def test_csr_and_sell_match_reference():
    """csr and sell_cs matvecs and their fused transforms: outputs and the
    gradients of x and w against jax.grad through the reference's XLA
    versions, float32 1e-4."""
    from repro.kernels import csr as RCSR
    from repro.kernels import sell_cs as RS
    from repro_torch.kernels import csr as TCSR
    from repro_torch.kernels import sell_cs as TS
    n = 80
    r, c, v = tp.random_edges(n, 420, 31)
    rcoo, pcoo = RF.coo_from_edges(n, n, r, c, v), TF.coo_from_edges(
        n, n, r, c, v)
    rcsr = RF.coo_to_csr(rcoo)
    pcsr = TF.to_device(TF.coo_to_csr(pcoo), tp.CPU)
    rsell, psell = RS.coo_to_sell(rcoo), TF.to_device(TS.coo_to_sell(pcoo),
                                                      tp.CPU)
    rng = np.random.default_rng(32)
    x, w, cot3, cot6 = (rng.standard_normal(s).astype(np.float32)
                        for s in ((n, 6), (6, 3), (n, 3), (n, 6)))
    cases = [
        (lambda x: RCSR.csr_matvec(rcsr, x),
         lambda x: TCSR.csr_matvec(pcsr, x), (x,), cot6),
        (lambda x, w: RCSR.csr_transform_matvec(rcsr, x, w),
         lambda x, w: TCSR.csr_transform_matvec(pcsr, x, w), (x, w), cot3),
        (lambda x: RS.sell_matvec(rsell, x),
         lambda x: TS.sell_matvec(psell, x), (x,), cot6),
        (lambda x, w: RS.sell_transform_matvec(rsell, x, w),
         lambda x, w: TS.sell_transform_matvec(psell, x, w), (x, w), cot3),
    ]
    for rfn, pfn, args, cot in cases:
        ref_y, ref_g = _grads_ref(rfn, [jnp.asarray(a) for a in args], cot)
        port_y, port_g = _grads_port(pfn, [torch.from_numpy(a)
                                           for a in args], cot)
        tp.assert_close(ref_y, port_y)
        for rg, pg in zip(ref_g, port_g):
            tp.assert_close(rg, pg)


def test_tcgnn_plan_curves_match_reference_from_its_params():
    """20 training steps through each tcgnn plan, the port's from the
    reference's own initial parameters, against repro.core.gnn.train
    (Pallas in interpret mode); curve tolerance atol 5e-3, rtol 1e-2, the
    reference's own (tests/test_fused.py)."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    port_g = TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                      g.n_classes, g.name)
    for plan in (("block_diag", "tcgnn_tile"),
                 ("block_diag_fused", "tcgnn_tile_fused")):
        ref_cfg = RGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8,
                                 selector="fixed", fixed_kernels=plan)
        ref = RGNN.train(g, ref_cfg, steps=20)
        params = RGNN.init_model(jax.random.PRNGKey(ref_cfg.seed), ref_cfg,
                                 g.features.shape[1], g.n_classes)
        params_np = [{k: np.asarray(a) for k, a in p.items()} for p in params]
        cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8,
                             selector="fixed", fixed_kernels=plan)
        port = TGNN.train(port_g, cfg, steps=20, device="cpu",
                          params=from_jax_params(params_np, device="cpu"))
        assert port.kernels == [tuple(k) for k in ref.kernels]
        np.testing.assert_allclose(port.losses, ref.losses, atol=5e-3,
                                   rtol=1e-2)


def test_dual_matvecs_match_reference_custom_vjps():
    """block_diag_dual_matvec(_acc): outputs and the gradients of x, w,
    w_self (and y_in) against jax.grad through the reference's custom VJPs
    (the dual Pallas kernel in interpret mode), float32 at 1e-4 and
    bfloat16 at atol 2e-1 / rtol 3e-1."""
    nb, B = 4, 8
    rng = np.random.default_rng(41)
    blocks, x, w, ws, y_in, cot = (
        rng.standard_normal(s).astype(np.float32) for s in
        ((nb, B, B), (nb * B, 5), (5, 3), (5, 3), (nb * B, 3), (nb * B, 3)))
    for jdt, tdt, tol in ((jnp.float32, torch.float32, tp.F32_TOL),
                          (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        rb, pb = jnp.asarray(blocks).astype(jdt), torch.from_numpy(
            blocks).to(tdt)
        cases = [
            (lambda x, w, ws: ROPS.block_diag_dual_matvec(rb, x, w, ws),
             lambda x, w, ws: ops.block_diag_dual_matvec(pb, x, w, ws),
             (x, w, ws)),
            (lambda x, w, ws, y: ROPS.block_diag_dual_matvec_acc(
                rb, x, w, ws, y),
             lambda x, w, ws, y: ops.block_diag_dual_matvec_acc(
                pb, x, w, ws, y), (x, w, ws, y_in)),
        ]
        for rfn, pfn, args in cases:
            ref_y, ref_g = _grads_ref(
                rfn, [jnp.asarray(a).astype(jdt) for a in args], cot)
            port_y, port_g = _grads_port(
                pfn, [torch.from_numpy(a).to(tdt) for a in args], cot)
            assert port_y.dtype == tdt
            tp.assert_close(np.asarray(ref_y, np.float32), port_y.float(),
                            **tol)
            assert len(port_g) == len(ref_g)
            for rg, pg in zip(ref_g, port_g):
                assert pg.dtype == tdt
                tp.assert_close(np.asarray(rg, np.float32), pg.float(), **tol)


SAGE_PLANS = (("block_diag", "bell"), ("block_diag_fused", "tcgnn_tile_fused"))


def _sage_cfgs(plan):
    return (RGNN.GNNConfig(model="sage", hidden=8, n_layers=2, comm_size=8,
                           selector="fixed", fixed_kernels=plan),
            TGNN.GNNConfig(model="sage", hidden=8, n_layers=2, comm_size=8,
                           selector="fixed", fixed_kernels=plan))


def test_sage_forward_matches_reference_from_carried_params():
    """SAGE logits from the reference's own parameters: the port's dual
    hook (acc=True: the diagonal tier's dual kernel) and its seed path
    (acc=False) against the reference's forward, which runs its seed path
    on the CPU."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    plan = SAGE_PLANS[1]
    ref_cfg, cfg = _sage_cfgs(plan)
    dec = RGNN.prepare(g, ref_cfg)
    params = RGNN.init_model(jax.random.PRNGKey(0), ref_cfg,
                             g.features.shape[1], g.n_classes)
    params_np = [{k: np.asarray(a) for k, a in p.items()} for p in params]
    ref_logits = np.asarray(RGNN.forward(
        params, ref_cfg, dec, RA.to_reordered(dec, jnp.asarray(g.features)),
        plan))
    port_g = TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                      g.n_classes, g.name)
    port_dec = TGNN.prepare(port_g, cfg, device="cpu")
    x = TA.to_reordered(port_dec, torch.from_numpy(g.features))
    port_params = from_jax_params(params_np, device="cpu")
    for acc in (True, False):
        logits = TGNN.forward(port_params, cfg, port_dec, x, plan, acc=acc)
        assert tuple(logits.shape) == ref_logits.shape
        tp.assert_close(ref_logits, logits)


def test_sage_plan_curves_match_reference_from_its_params():
    """20 SAGE training steps through the seed plan and the dual plan, the
    port's from the reference's own initial parameters, against
    repro.core.gnn.train; both run the seed path on the CPU (acc off), the
    dual hook is held to the reference by the two tests above.  Curve
    tolerance atol 5e-3, rtol 1e-2 (tests/test_fused.py)."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    port_g = TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                      g.n_classes, g.name)
    for plan in SAGE_PLANS:
        ref_cfg, cfg = _sage_cfgs(plan)
        ref = RGNN.train(g, ref_cfg, steps=20)
        params = RGNN.init_model(jax.random.PRNGKey(ref_cfg.seed), ref_cfg,
                                 g.features.shape[1], g.n_classes)
        params_np = [{k: np.asarray(a) for k, a in p.items()} for p in params]
        port = TGNN.train(port_g, cfg, steps=20, device="cpu",
                          params=from_jax_params(params_np, device="cpu"))
        assert port.kernels == [tuple(k) for k in ref.kernels]
        assert ref.losses[-1] < ref.losses[0]
        np.testing.assert_allclose(port.losses, ref.losses, atol=5e-3,
                                   rtol=1e-2)
