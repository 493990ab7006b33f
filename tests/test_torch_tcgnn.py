"""The port's csr, sell_cs and tcgnn_tile registrations on the CPU: their
payloads byte-identical to the reference's (host numpy in both
packages), their matvecs against dense products, float64 gradcheck of the
four tcgnn autograd Functions through the plain versions, the tcgnn
wrappers' CPU contract, and the two tcgnn GCN plans against a dense GCN.
Parity with the reference's Pallas kernels (interpret mode) is in
tests/test_torch_jax_parity.py; the CUDA kernels are checked on the card
by tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.kernels import sell_cs as RS
from repro.kernels import tcgnn_tile as RT
from repro_torch.core import adaptgear as TA
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.graphs import graph as TG
from repro_torch.kernels import csr as TCSR
from repro_torch.kernels import sell_cs as TS
from repro_torch.kernels import tcgnn_tile as TT

TC_PLANS = [("block_diag", "tcgnn_tile"),
            ("block_diag_fused", "tcgnn_tile_fused")]


def _assert_payload_equal(ref, port) -> None:
    """Every field of a format container: arrays byte for byte, the rest
    by value."""
    arrays = TF.ARRAY_FIELDS[type(port)]
    for f in dataclasses.fields(port):
        if f.name in arrays:
            tp.assert_bytes_equal(getattr(ref, f.name), getattr(port, f.name))
        else:
            assert getattr(ref, f.name) == getattr(port, f.name), f.name


def _dense(n_rows, n_cols, r, c, v) -> np.ndarray:
    a = np.zeros((n_rows, n_cols), np.float64)
    np.add.at(a, (r, c), v)
    return a


@pytest.mark.parametrize("n,e,seed", [(64, 300, 0), (90, 40, 1)])
def test_csr_payload_byte_identical(n, e, seed):
    r, c, v = tp.random_edges(n, e, seed)
    _assert_payload_equal(RF.coo_to_csr(RF.coo_from_edges(n, n, r, c, v)),
                          TF.coo_to_csr(TF.coo_from_edges(n, n, r, c, v)))


@pytest.mark.parametrize("chunk,sigma", [(8, None), (4, 16), (3, 5)])
def test_sell_payload_byte_identical(chunk, sigma):
    n = 70
    r, c, v = tp.random_edges(n, 400, chunk)
    r[:5] = 3                                   # a hub row
    ref = RS.coo_to_sell(RF.coo_from_edges(n, n, r, c, v), chunk, sigma)
    port = TS.coo_to_sell(TF.coo_from_edges(n, n, r, c, v), chunk, sigma)
    _assert_payload_equal(ref, port)
    assert port.n_slots == ref.n_slots >= len(np.unique(r * n + c))


@pytest.mark.parametrize("B,e", [(8, 500), (16, 900), (8, 0)])
def test_tcgnn_payload_byte_identical(B, e):
    n = 96
    r, c, v = tp.random_edges(n, max(e, 1), B, block=B, spread=3)
    if e == 0:
        r, c, v = r[:0], c[:0], v[:0]
    coo, coo_t = (TF.coo_from_edges(n, n, r, c, v),
                  TF.coo_from_edges(n, n, c, r, v))
    ref = RT._tcgnn_build(RF.coo_from_edges(n, n, r, c, v),
                          RF.coo_from_edges(n, n, c, r, v), B, {})
    port = TT._tcgnn_build(coo, coo_t, B, {})
    for rp, pp in zip(ref, port):
        _assert_payload_equal(rp, pp)
        assert pp.n_cond % 128 == 0


def test_tcgnn_budget_capped_build_is_not_ported_yet():
    """The budget-capped build (once refused, now ported): with an edge
    budget the payload is the reference's triple ``(tc, tc_t, spill)``,
    C the lane-rounded cap, byte for byte at a spilling budget too."""
    n, B = 512, 8
    r, c, v = tp.random_edges(n, 16000, 5)     # ~250 columns a block row
    for budget in (100000, 1024):               # C = 512 (no cap), 128
        stats = {"edge_budget": budget}
        ref = RT._tcgnn_build(RF.coo_from_edges(n, n, r, c, v), None, B,
                              stats)
        port = TT._tcgnn_build(TF.coo_from_edges(n, n, r, c, v), None, B,
                               stats)
        assert len(port) == 3 and port[0].budgeted and port[1].budgeted
        assert port[0].n_cond == TT.tcgnn_budget_c(budget, n, B)
        for rp, pp in zip(ref[:2], port[:2]):
            _assert_payload_equal(rp, pp)
        for f in ("rows", "cols", "vals"):
            tp.assert_bytes_equal(getattr(ref[2], f), getattr(port[2], f))
        assert (port[2].nnz > 0) == (budget == 1024)


def _payloads(n=48, e=150, seed=0, B=8, dtype=torch.float64):
    """csr, sell and tcgnn (tc, tc_t) payloads of one random graph on the
    CPU, float values cast to ``dtype``, and its dense adjacency."""
    r, c, v = tp.random_edges(n, e, seed, block=B, spread=2)
    coo = TF.coo_from_edges(n, n, r, c, v)
    csr = TF.to_device(TF.coo_to_csr(coo), tp.CPU)
    sell = TF.to_device(TS.coo_to_sell(coo), tp.CPU)
    tc = TF.to_device(TT._tcgnn_build(coo, TF.coo_from_edges(n, n, c, r, v),
                                      B, {}), tp.CPU)
    csr = dataclasses.replace(csr, vals=csr.vals.to(dtype))
    sell = dataclasses.replace(sell, vals=sell.vals.to(dtype))
    tc = tuple(dataclasses.replace(p, tiles=p.tiles.to(dtype)) for p in tc)
    return csr, sell, tc, torch.from_numpy(_dense(n, n, r, c, v))


@pytest.mark.parametrize("op", ["csr", "csr_fused", "sell", "sell_fused"])
def test_csr_and_sell_match_dense_and_pass_gradcheck(op):
    csr, sell, _, a = _payloads(seed=len(op))
    rng = np.random.default_rng(len(op))
    x = torch.from_numpy(rng.standard_normal((48, 5))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((5, 3))).requires_grad_()
    fn, want = {
        "csr": (lambda x, w: TCSR.csr_matvec(csr, x), lambda: a @ x),
        "csr_fused": (lambda x, w: TCSR.csr_transform_matvec(csr, x, w),
                      lambda: a @ (x @ w)),
        "sell": (lambda x, w: TS.sell_matvec(sell, x), lambda: a @ x),
        "sell_fused": (lambda x, w: TS.sell_transform_matvec(sell, x, w),
                       lambda: a @ (x @ w)),
    }[op]
    torch.testing.assert_close(fn(x, w), want(), atol=1e-10, rtol=1e-10)
    assert torch.autograd.gradcheck(fn, (x, w))


def test_tcgnn_plain_versions_match_dense():
    _, _, (tc, tc_t), a = _payloads(n=64, e=300, seed=4)
    rng = np.random.default_rng(4)
    x, y_in = (torch.from_numpy(rng.standard_normal(s)) for s in
               ((64, 6), (64, 6)))
    w, g = (torch.from_numpy(rng.standard_normal(s)) for s in ((6, 3),
                                                               (64, 3)))
    tol = dict(atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(TT.plain(tc.tiles, tc.gather_idx, x, y_in),
                               a @ x + y_in, **tol)
    torch.testing.assert_close(
        TT.plain_fused(tc.tiles, tc.gather_idx, x, w), a @ (x @ w), **tol)
    torch.testing.assert_close(TT.plain(tc_t.tiles, tc_t.gather_idx, x),
                               a.T @ x, **tol)
    torch.testing.assert_close(
        TT.plain_dw(tc_t.tiles, tc_t.gather_idx, x, g), x.T @ (a.T @ g),
        **tol)


@pytest.mark.parametrize("op", ["tcgnn", "tcgnn_acc", "tcgnn_fused",
                                "tcgnn_fused_acc"])
def test_tcgnn_functions_pass_gradcheck(op):
    """The four Functions' backward (dX over tc_t, the fused dX with W^T,
    the dW reduction, y_in's pass-through) against finite differences, in
    float64 through the plain versions."""
    _, _, (tc, tc_t), _ = _payloads(seed=len(op))
    rng = np.random.default_rng(len(op))
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s)).requires_grad_()
    x, w = t(48, 5), t(5, 3)
    fn, inputs = {
        "tcgnn": (lambda x: TT.tcgnn_matvec(tc, tc_t, x), (x,)),
        "tcgnn_acc": (lambda x, y: TT.tcgnn_matvec_acc(tc, tc_t, x, y),
                      (x, t(48, 5))),
        "tcgnn_fused": (lambda x, w: TT.tcgnn_fused_matvec(tc, tc_t, x, w),
                        (x, w)),
        "tcgnn_fused_acc": (lambda x, w, y: TT.tcgnn_fused_matvec_acc(
            tc, tc_t, x, w, y), (x, w, t(48, 3))),
    }[op]
    assert torch.autograd.gradcheck(fn, inputs)


def test_tcgnn_wrappers_run_plain_on_cpu_without_launching():
    _, _, (tc, tc_t), _ = _payloads(dtype=torch.float32)
    rng = np.random.default_rng(9)
    x, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((48, 5), (48, 3)))
    w = x[:5, :3].contiguous()
    counts = (TT.launches, TT.fused_launches, TT.dw_launches)
    before = [c.value for c in counts]
    for got, want in [
            (TT.tcgnn_spmm(tc.tiles, tc.gather_idx, x),
             TT.plain(tc.tiles, tc.gather_idx, x)),
            (TT.tcgnn_spmm_fused(tc.tiles, tc.gather_idx, x, w, g),
             TT.plain_fused(tc.tiles, tc.gather_idx, x, w, g)),
            (TT.tcgnn_spmm_dw(tc_t.tiles, tc_t.gather_idx, x, g),
             TT.plain_dw(tc_t.tiles, tc_t.gather_idx, x, g))]:
        assert torch.equal(got, want)
    assert [c.value for c in counts] == before


@pytest.mark.parametrize("case", ["tiles_dim", "gather_shape", "y_in",
                                  "fused_w", "fused_dtype", "dw_x"])
def test_tcgnn_wrappers_reject_bad_operands(case):
    tiles = torch.zeros((4, 8, 128))
    gi = torch.zeros((4, 128), dtype=torch.int32)
    x = torch.zeros((32, 5))
    w = torch.zeros((5, 2))
    with pytest.raises(ValueError):
        if case == "tiles_dim":
            TT.tcgnn_spmm(tiles[0], gi, x)
        elif case == "gather_shape":
            TT.tcgnn_spmm(tiles, gi[:, :64], x)
        elif case == "y_in":
            TT.tcgnn_spmm(tiles, gi, x, torch.zeros((32, 4)))
        elif case == "fused_w":
            TT.tcgnn_spmm_fused(tiles, gi, x, torch.zeros((4, 2)))
        elif case == "fused_dtype":
            TT.tcgnn_spmm_fused(tiles, gi, x, w.double())
        else:
            TT.tcgnn_spmm_dw(tiles, gi, torch.zeros((30, 5)),
                             torch.zeros((32, 2)))


@functools.lru_cache(maxsize=None)
def _prepared():
    g = tp.ref_graph("pubmed", 0.03, comm_size=8, max_feat=32)
    g = TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                 g.n_classes, g.name)
    cfg = TGNN.GNNConfig(hidden=8, n_layers=2, comm_size=8, inter_buckets=2,
                         selector="fixed")
    return g, cfg, TGNN.prepare(g, cfg, device="cpu")


@pytest.mark.parametrize("plan", TC_PLANS)
def test_tcgnn_plans_match_dense_gcn_fwd_and_grads(plan):
    """Two GCN layers through each tcgnn plan (acc off and on, two inter
    buckets) against the dense-adjacency GCN: logits and every
    parameter's gradient, float32 1e-4."""
    g, cfg, dec = _prepared()
    gl = TG.add_self_loops(g)
    vals = TG.gcn_norm_values(gl.n, gl.senders, gl.receivers)
    a = np.zeros((g.n, g.n), np.float32)
    a[gl.receivers, gl.senders] = vals       # duplicated self-loops: once
    a = torch.from_numpy(a)
    feats = torch.from_numpy(g.features)
    rng = np.random.default_rng(5)
    params = [dict(w=rng.uniform(-0.4, 0.4, (fi, fo)).astype(np.float32),
                   b=rng.standard_normal(fo).astype(np.float32) * 0.1)
              for fi, fo in [(feats.shape[1], 8), (8, g.n_classes)]]
    cot = torch.from_numpy(rng.standard_normal(
        (g.n, g.n_classes)).astype(np.float32))
    want_p = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
              for p in params]
    h = feats
    for i, p in enumerate(want_p):
        h = a @ (h @ p["w"]) + p["b"]
        h = torch.relu(h) if i == 0 else h
    (h * cot).sum().backward()
    for acc in (False, True):
        got_p = [{k: torch.from_numpy(v).requires_grad_()
                  for k, v in p.items()} for p in params]
        x = TA.to_reordered(dec, feats)
        got = TA.from_reordered(dec, TGNN.forward(got_p, cfg, dec, x, plan,
                                                  acc=acc))
        tp.assert_close(h.detach(), got)
        (got * cot).sum().backward()
        for pw, pg in zip(want_p, got_p):
            for k in ("w", "b"):
                tp.assert_close(pw[k].grad, pg[k].grad)


@pytest.mark.parametrize("fused", [False, True])
def test_tcgnn_dx_pass_runs_only_when_autograd_asks(monkeypatch, fused):
    """The dX pass over tc_t runs only when the input needs a gradient;
    the fused dW reduction runs whenever W does."""
    calls = []
    name = "tcgnn_spmm_fused" if fused else "tcgnn_spmm"
    for fn in (name, "tcgnn_spmm_dw"):
        real = getattr(TT, fn)

        def spy(*args, _real=real, _name=fn, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(TT, fn, spy)
    _, _, (tc, tc_t), _ = _payloads(dtype=torch.float32)
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.standard_normal((48, 5)).astype(np.float32))
    for needs in (False, True):
        x = x0.clone().requires_grad_(needs)
        w = torch.ones((5, 3), requires_grad=True)
        y = (TT.tcgnn_fused_matvec(tc, tc_t, x, w) if fused
             else TT.tcgnn_matvec(tc, tc_t, x @ w))
        calls.clear()
        y.sum().backward()
        if fused:
            assert calls == ([name] if needs else []) + ["tcgnn_spmm_dw"]
        else:
            assert calls == [name]               # dH, needed for dW
        assert (x.grad is not None) == needs and w.grad is not None


def _chip_smoke():
    """chip_smoke.py as a module (it imports only the standard library)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("block_size", [8, 16])
def test_tcgnn_padding_is_a_suffix_of_each_block_row(block_size):
    """What tcgnn_spmm_fused's skip of padded slots relies on, on the
    main path's payloads (``prepare`` of a pubmed-shaped graph, forward
    and transpose): in every block row the slots before ``real_slots``
    each hold a non-zero and the slots past it are all-zero tile columns
    with gather_idx 0; and ``real_slots`` sums to what chip_smoke.py's
    ``real_slot_count`` counts."""
    cs = _chip_smoke()
    g = TG.synth_dataset("pubmed", scale=0.05, seed=0)
    cfg = TGNN.GNNConfig(hidden=16, n_layers=2, comm_size=block_size,
                         reorder="bfs", inter_buckets=1, selector="fixed",
                         fixed_kernels=("block_diag", "tcgnn_tile"), seed=0)
    dec = TGNN.prepare(g, cfg, device="cpu")
    for p in dec.sub("inter").formats["tcgnn_tile"]:
        k = TT.real_slots(p.tiles)
        assert k.shape == (p.n_brow,) and int(k.max()) <= p.n_cond
        live = torch.arange(p.n_cond)[None, :] < k[:, None]
        assert torch.equal((p.tiles != 0).any(dim=1), live)
        assert not p.gather_idx[~live].any()
        assert int(k.sum()) == cs.real_slot_count(p.tiles) > 0


def test_tcgnn_real_slots_counts_to_the_last_non_zero_column():
    """real_slots is one past a row's last non-zero tile column, whatever
    lies before it (zero columns inside, a NaN) and 0 for an empty row."""
    tiles = torch.zeros((4, 2, 6))
    tiles[1, 0, 0] = 1.0
    tiles[2, 1, 4] = -2.0                     # zero columns 0..3 before it
    tiles[3, 0, 2] = float("nan")
    assert TT.real_slots(tiles).tolist() == [0, 1, 5, 3]
    assert TT.real_slots(torch.zeros((0, 2, 6))).shape == (0,)


@pytest.mark.parametrize("block_size", [8, 16])
def test_tcgnn_dw_over_real_slots_matches_all_slots(block_size):
    """What tcgnn_spmm_dw's skip of padded slots relies on, on the main
    path's transpose payload (``prepare`` of a pubmed-shaped graph): dW
    summed over each block row's slots cut at ``real_slots`` equals dW over
    all C slots (float32, 1e-4), whichever rows of g the cut slots name."""
    g = TG.synth_dataset("pubmed", scale=0.05, seed=0)
    cfg = TGNN.GNNConfig(hidden=16, n_layers=2, comm_size=block_size,
                         reorder="bfs", inter_buckets=1, selector="fixed",
                         fixed_kernels=("block_diag", "tcgnn_tile"), seed=0)
    dec = TGNN.prepare(g, cfg, device="cpu")
    tc_t = dec.sub("inter").formats["tcgnn_tile"][1]
    tiles, gi = tc_t.tiles, tc_t.gather_idx
    k = TT.real_slots(tiles)
    assert 0 < int(k.max()) < tc_t.n_cond
    rng = np.random.default_rng(block_size)
    n = tc_t.n_rows
    for fi, fo in ((500, 16), (16, 3)):
        x = torch.from_numpy(rng.standard_normal((n, fi)).astype(np.float32))
        gg = torch.from_numpy(rng.standard_normal((n, fo)).astype(np.float32))
        want = TT.plain_dw(tiles, gi, x, gg)
        kmax = int(k.max())
        tp.assert_close(want, TT.plain_dw(tiles[:, :, :kmax].contiguous(),
                                          gi[:, :kmax].contiguous(), x, gg))
        cut = torch.arange(tc_t.n_cond)[None, :] >= k[:, None]
        other = torch.from_numpy(rng.integers(0, n, gi.shape, np.int32))
        tp.assert_close(want, TT.plain_dw(tiles, torch.where(cut, other, gi),
                                          x, gg))


def test_tcgnn_dw_splits_are_fixed_and_cover_every_block_row():
    """tcgnn_spmm_dw's partial sums: a fixed number of block rows each (not
    taken from the card), every row in exactly one split, and at pubmed's
    1233 transpose block rows one wave of CTAs over an H100's 132 SMs.  At
    most 16 rows a split, so phase a of the kernel gives each row a warp."""
    r = TT.DW_ROWS_PER_SPLIT
    assert isinstance(r, int) and 1 <= r <= 16
    assert TT.dw_splits(1233) == 124 <= 132
    for nbr in (1, 9, 10, 11, 1233):
        s = TT.dw_splits(nbr)
        assert (s - 1) * r < nbr <= s * r
    assert TT.dw_splits(0) == 0


def _global_functions() -> dict:
    """The __global__ functions of each kernel source under csrc/, with
    those of the headers it includes: {source stem: {name, ...}}."""
    import re
    csrc = Path(TT.__file__).resolve().parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    own = {p.name: set(pat.findall(p.read_text()))
           for p in csrc.glob("*.cu*")}
    out = {}
    for p in csrc.glob("*.cu"):
        names = set(own[p.name])
        for h in re.findall(r'#include "(\w+\.cuh)"', p.read_text()):
            names |= own[h]
        out[p.stem] = names
    return out


@pytest.mark.parametrize("kernel", ["block_diag_spmm", "bell_spmm",
                                    "block_diag_spmm_fused",
                                    "bell_spmm_fused", "bell_spmm_dw",
                                    "tcgnn_spmm", "tcgnn_spmm_fused",
                                    "tcgnn_spmm_dw", "block_diag_spmm_dual"])
def test_chip_smoke_device_functions_name_one_kernel_each(kernel):
    """chip_smoke.py checks the GNN profiles' kernel events by DEVICE_FNS:
    each of a kernel's names is a part of a __global__ function of its own
    source and of no source whose kernels do not list that name, so the
    events it counts are those kernels' launches and no others."""
    cs = _chip_smoke()
    fns = _global_functions()
    src = Path(cs.KERNELS[kernel]["source"]).stem
    for name in cs.DEVICE_FNS[kernel]:
        assert any(name in f for f in fns[src]), (kernel, name)
        sharing = {Path(cs.KERNELS[k]["source"]).stem
                   for k, names in cs.DEVICE_FNS.items() if name in names}
        for other, names in fns.items():
            if other not in sharing:
                assert not any(name in f for f in names), (name, other)


def test_chip_smoke_device_events_of_the_fixed_plans():
    """device_events turns launches per step into device events per
    step: one event of each device function a launch runs (both dW kernels
    end in the shared reduction), summed over the kernels that share it."""
    cs = _chip_smoke()
    assert cs.device_events(cs.PER_STEP["tcgnn_unfused"]) == {
        "block_diag_kernel": 4, "tcgnn_spmm_": 4}
    assert cs.device_events(cs.PER_STEP["tcgnn_fused"]) == {
        "bell_fused_": 3, "tcgnn_fused_": 3, "tcgnn_dw_partial_kernel": 2,
        "bell_dw_partial_kernel": 2, "dw_reduce_kernel": 4}
    assert cs.device_events(cs.SAGE_PER_STEP["sage_dual"]) == {
        "block_diag_dual_": 2, "bell_fused_": 1, "bell_dw_partial_kernel": 2,
        "dw_reduce_kernel": 4, "tcgnn_fused_": 3,
        "tcgnn_dw_partial_kernel": 2}
    assert cs.device_events(cs.PER_FORWARD["unfused"]) == {
        "block_diag_kernel": 2, "bell_kernel": 2}
    # a feedback plan's launches per step, as chip_smoke.py takes them
    layers = (("block_diag_fused", "tcgnn_tile"),
              ("block_diag_fused", "tcgnn_tile_fused"))
    one, none = (cs.plan_launches(layers, n) for n in (1, 0))
    assert cs.device_events({k: one[k] - none[k] for k in one}) == {
        "bell_fused_": 3, "bell_dw_partial_kernel": 2, "dw_reduce_kernel": 3,
        "tcgnn_spmm_": 2, "tcgnn_fused_": 2,
        "tcgnn_dw_partial_kernel": 1}
