"""Port parity against the JAX reference where the reference compiles:
the kernel modules (the reference's ``ops.*_matvec(_acc)`` run the Pallas
kernels in interpret mode on the CPU) and the whole slice
(``repro.core.gnn.forward`` from the reference's own parameters).
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
                             fixed_kernels=plan)
        port = TGNN.train(port_g, cfg, steps=5, device="cpu",
                          params=from_jax_params(params_np, device="cpu"))
        assert port.kernels == [tuple(k) for k in ref.kernels]
        np.testing.assert_allclose(port.losses, ref.losses, atol=5e-3,
                                   rtol=1e-2)
