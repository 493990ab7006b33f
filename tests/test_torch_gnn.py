"""The port's GCN read path on the CPU (prepare -> init_model -> forward)
against dense NumPy references, and its package rules: entry points
default to CUDA, and importing it pulls in neither jax nor repro.  The
same forward against ``repro.core.gnn.forward`` is in
tests/test_torch_jax_parity.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import adaptgear as TA
from repro_torch.core import decompose as TD
from repro_torch.core import gnn as TGNN
from repro_torch.graphs import graph as TG
from repro_torch.weights import from_jax_params

PLAN = ("block_diag", "bell")
SRC = Path(__file__).resolve().parent.parent / "src"


def _port_graph(g):
    return TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                    g.n_classes, g.name)


@functools.lru_cache(maxsize=None)
def _slice(k: int = 1):
    """A small pubmed-like graph prepared on the CPU, and GCN parameters
    (as numpy, the reference's layout: w (in, out), b (out,))."""
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8, inter_buckets=k)
    dec = TGNN.prepare(_port_graph(g), cfg, device="cpu")
    rng = np.random.default_rng(7)
    params_np = [dict(w=rng.uniform(-0.4, 0.4, (fi, fo)).astype(np.float32),
                      b=rng.standard_normal(fo).astype(np.float32) * 0.1)
                 for fi, fo in [(g.features.shape[1], 8), (8, g.n_classes)]]
    return g, cfg, dec, params_np


def _dense_adjacency(g) -> np.ndarray:
    """Â with self-loops and the symmetric norm, as the block formats store
    it.  add_self_loops duplicates the graph's own (v, v) edges; the block
    formats store a duplicated edge once, as the reference's builders do
    (both copies carry the same norm value), so assign rather than add."""
    gl = TG.add_self_loops(_port_graph(g))
    vals = TG.gcn_norm_values(gl.n, gl.senders, gl.receivers)
    a = np.zeros((g.n, g.n), np.float32)
    a[gl.receivers, gl.senders] = vals
    return a


@pytest.mark.parametrize("k,acc", [(1, False), (1, True), (2, True)])
def test_gcn_forward_matches_dense_gcn(k, acc):
    g, cfg, dec, params_np = _slice(k)
    assert len(dec.subgraphs) == k + 1
    params = from_jax_params(params_np, device="cpu")
    x = TA.to_reordered(dec, torch.from_numpy(g.features))
    logits = TGNN.forward(params, cfg, dec, x, PLAN, acc=acc)
    assert tuple(logits.shape) == (dec.n_pad, g.n_classes)
    a = _dense_adjacency(g)
    h = np.maximum(a @ (g.features @ params_np[0]["w"]) + params_np[0]["b"], 0)
    tp.assert_close(a @ (h @ params_np[1]["w"]) + params_np[1]["b"],
                    TA.from_reordered(dec, logits))


def test_aggregate_matches_dense_adjacency():
    g, _, dec, _ = _slice()
    assert (g.senders == g.receivers).any()   # the duplicated-edge case
    a = _dense_adjacency(g)
    x = np.random.default_rng(2).standard_normal((g.n, 6)).astype(np.float32)
    xr = TA.to_reordered(dec, torch.from_numpy(x))
    for acc in (False, True):
        y = TA.from_reordered(dec, TA.aggregate(dec, xr, PLAN, acc=acc))
        tp.assert_close(a @ x, y)


def test_reorder_round_trip():
    g, _, dec, _ = _slice()
    x = torch.from_numpy(g.features)
    xr = TA.to_reordered(dec, x)
    assert xr.shape[0] == dec.n_pad and not xr[dec.n:].any()
    assert torch.equal(TA.from_reordered(dec, xr), x)


def test_from_jax_params_checks_the_gcn_layout():
    _, _, _, params_np = _slice()
    params = from_jax_params(params_np, device="cpu")
    assert [tuple(p["w"].shape) for p in params] == [(32, 8), (8, 3)]
    assert all(p["w"].dtype == torch.float32 for p in params)
    with pytest.raises(ValueError, match="GCN keys"):
        from_jax_params([dict(w=params_np[0]["w"])], device="cpu")
    with pytest.raises(ValueError, match="not"):
        from_jax_params([dict(w=params_np[0]["w"], b=params_np[1]["b"])],
                        device="cpu")


def test_from_jax_params_checks_the_gin_layout():
    rng = np.random.default_rng(0)
    u = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    layer = dict(eps=np.float32(0.25), w1=u(5, 8), b1=u(8), w2=u(8, 3),
                 b2=u(3))
    (p,) = from_jax_params([layer], device="cpu")
    assert p["eps"].shape == () and float(p["eps"]) == 0.25
    assert [tuple(p[k].shape) for k in ("w1", "b1", "w2", "b2")] == [
        (5, 8), (8,), (8, 3), (3,)]
    for k in layer:                       # copied, not shared
        assert np.array_equal(p[k].numpy(), layer[k])
        p[k].add_(1.0)
    assert float(layer["eps"]) == 0.25
    for bad, match in ((dict(layer, eps=np.zeros(1, np.float32)), "scalar"),
                       (dict(layer, b1=u(7)), "not"),
                       (dict(layer, w2=u(7, 3)), "chain"),
                       ({k: v for k, v in layer.items() if k != "b2"},
                        "GIN keys")):
        with pytest.raises(ValueError, match=match):
            from_jax_params([bad], device="cpu")


def test_init_gin_draws_glorot_and_zero_eps():
    cfg = TGNN.GNNConfig(model="gin", hidden=8, n_layers=3)
    p1, p2 = (TGNN.init_model(torch.Generator().manual_seed(5), cfg, 32, 3,
                              device="cpu") for _ in range(2))
    assert [(tuple(p["w1"].shape), tuple(p["w2"].shape)) for p in p1] == [
        ((32, 8), (8, 8)), ((8, 8), (8, 8)), ((8, 8), (8, 3))]
    for a, b in zip(p1, p2):
        assert float(a["eps"]) == 0.0 and a["eps"].shape == ()
        assert not a["b1"].any() and not a["b2"].any()
        for k in ("w1", "w2"):
            assert torch.equal(a[k], b[k])
            lim = (6.0 / sum(a[k].shape)) ** 0.5
            assert float(a[k].abs().max()) <= lim


def test_init_model_draws_glorot_from_the_generator():
    cfg = TGNN.GNNConfig(hidden=8)
    p1 = TGNN.init_model(torch.Generator().manual_seed(5), cfg, 32, 3,
                         device="cpu")
    p2 = TGNN.init_model(torch.Generator().manual_seed(5), cfg, 32, 3,
                         device="cpu")
    assert [tuple(p["w"].shape) for p in p1] == [(32, 8), (8, 3)]
    for a, b in zip(p1, p2):
        assert torch.equal(a["w"], b["w"]) and not a["b"].any()
        lim = (6.0 / sum(a["w"].shape)) ** 0.5
        assert float(a["w"].abs().max()) <= lim


def _entry_points():
    g = _port_graph(tp.ref_graph())
    cfg = TGNN.GNNConfig(comm_size=8)
    skel = TD.decompose_skeleton(g, comm_size=8)
    return {
        "prepare": lambda: TGNN.prepare(g, cfg),
        "decompose": lambda: TD.decompose(g, comm_size=8),
        "materialize": lambda: skel.materialize(),
        "init_model": lambda: TGNN.init_model(torch.Generator(), cfg, 4, 3),
        "from_jax_params": lambda: from_jax_params(
            [dict(w=np.zeros((4, 3), np.float32),
                  b=np.zeros(3, np.float32))]),
    }


@pytest.mark.parametrize("entry", ["prepare", "decompose", "materialize",
                                   "init_model", "from_jax_params"])
def test_entry_points_default_to_cuda(entry):
    fn = _entry_points()[entry]
    if torch.cuda.is_available():
        out = fn()
        first = out[0]["w"] if isinstance(out, list) else out.perm
        assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_package_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.weights\n"
        "import repro_torch.core.gnn, repro_torch.kernels.registry\n"
        "import repro_torch.sampling, repro_torch.obs\n"
        "import repro_torch.train.gnn_steps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.core.gnn' in sys.modules\n"
        "assert 'repro_torch.train.gnn_steps' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
