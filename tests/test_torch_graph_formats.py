"""Port parity: graphs/graph.py and core/formats.py (+ the blocked-ELL
tiling rules of kernels/registry.py).  Everything here is host numpy in
both packages, so the port must give byte-identical arrays."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.graphs import graph as RG
from repro.kernels import registry as RR
from repro_torch.core import formats as TF
from repro_torch.graphs import graph as TG
from repro_torch.kernels import registry as TR


@pytest.mark.parametrize("name,scale,comm", [("citeseer", 0.02, 8),
                                             ("pubmed", 0.03, 16)])
def test_synth_dataset_byte_identical(name, scale, comm):
    kw = dict(seed=3, comm_size=comm, max_feat=48)
    ref, port = RG.synth_dataset(name, scale, **kw), TG.synth_dataset(
        name, scale, **kw)
    assert (ref.n, ref.n_classes, ref.name, ref.n_edges) == (
        port.n, port.n_classes, port.name, port.n_edges)
    for f in ("senders", "receivers", "features", "labels"):
        tp.assert_bytes_equal(getattr(ref, f), getattr(port, f))
    assert RG.TABLE1 == TG.TABLE1


def test_self_loops_and_gcn_norm_byte_identical():
    g = tp.ref_graph()
    port_g = TG.Graph(g.n, g.senders, g.receivers, g.features, g.labels,
                      g.n_classes, g.name)
    ref_l, port_l = RG.add_self_loops(g), TG.add_self_loops(port_g)
    tp.assert_bytes_equal(ref_l.senders, port_l.senders)
    tp.assert_bytes_equal(ref_l.receivers, port_l.receivers)
    tp.assert_bytes_equal(
        RG.gcn_norm_values(g.n, ref_l.senders, ref_l.receivers),
        TG.gcn_norm_values(g.n, port_l.senders, port_l.receivers))


def _coo_pair(n=96, e=300, seed=0, **kw):
    r, c, v = tp.random_edges(n, e, seed, **kw)
    order = np.random.default_rng(seed + 7).permutation(len(r))  # unsorted
    return (RF.coo_from_edges(n, n, r[order], c[order], v[order]),
            TF.coo_from_edges(n, n, r[order], c[order], v[order]))


def test_coo_from_edges_byte_identical():
    ref, port = _coo_pair()
    assert (ref.n_rows, ref.n_cols) == (port.n_rows, port.n_cols)
    for f in ("rows", "cols", "vals"):
        tp.assert_bytes_equal(getattr(ref, f), getattr(port, f))


def test_blockdiag_payload_byte_identical():
    n, B = 64, 8
    r, c, v = tp.random_edges(n, 200, 1, block=B, spread=0)
    ref = RF.coo_to_blockdiag(RF.coo_from_edges(n, n, r, c, v), B)
    port = TF.coo_to_blockdiag(TF.coo_from_edges(n, n, r, c, v), B)
    assert (ref.n, ref.block_size) == (port.n, port.block_size)
    tp.assert_bytes_equal(ref.blocks, port.blocks)


def test_blockdiag_rejects_off_diagonal_edges():
    coo = TF.coo_from_edges(16, 16, np.array([0]), np.array([9]))
    with pytest.raises(ValueError, match="off the block diagonal"):
        TF.coo_to_blockdiag(coo, 8)


@pytest.mark.parametrize("B,spread", [(8, 0), (16, 2)])
def test_bell_payload_byte_identical(B, spread):
    ref_coo, port_coo = _coo_pair(n=128, e=400, seed=B, block=B,
                                  spread=spread)
    ref = RF.coo_to_bell(ref_coo, B, f_tile_cap=RR._bell_f_cap(B))
    port = TF.coo_to_bell(port_coo, B, f_tile_cap=TR._bell_f_cap(B))
    for f in ("n_rows", "n_cols", "block_size", "max_blocks", "f_tile_cap",
              "budgeted", "n_brow"):
        assert getattr(ref, f) == getattr(port, f), f
    for f in ("blocks", "col_idx", "n_valid"):
        tp.assert_bytes_equal(getattr(ref, f), getattr(port, f))
    # the format's contract the CUDA kernel relies on: slots past n_valid
    # are all-zero blocks pointing at block column 0
    slot = np.arange(port.max_blocks)[None, :]
    pad = slot >= port.n_valid[:, None]
    assert not port.blocks[pad].any() and not port.col_idx[pad].any()


def test_ell_payload_byte_identical():
    ref_coo, port_coo = _coo_pair(n=80, e=250, seed=5)
    ref, port = RF.coo_to_ell(ref_coo), TF.coo_to_ell(port_coo)
    assert (ref.n_rows, ref.n_cols, ref.max_deg) == (port.n_rows, port.n_cols,
                                                     port.max_deg)
    for f in ("indices", "vals", "mask"):
        tp.assert_bytes_equal(getattr(ref, f), getattr(port, f))


def test_bell_pick_block_identical():
    """The block size rule picks 1x, 2x or 4x the community size; the port
    must pick the same on scattered and on clustered tiers."""
    picks = []
    for seed, kw in [(0, {}), (1, dict(block=32, spread=0)),
                     (2, dict(block=16, spread=1))]:
        ref_coo, port_coo = _coo_pair(n=128, e=500, seed=seed, **kw)
        ref = RR._bell_pick_block(ref_coo, 8)
        assert TR._bell_pick_block(port_coo, 8) == ref
        picks.append(ref)
    assert len(set(picks)) >= 2, picks      # the cases exercise the rule


def test_bell_f_cap_identical():
    for B in (8, 16, 32, 64):
        assert TR._bell_f_cap(B) == RR._bell_f_cap(B)


def test_to_device_places_every_array_field():
    _, coo = _coo_pair(n=64, e=120, seed=9)
    bell = TF.coo_to_bell(coo, 8)
    placed = TF.to_device((bell, TF.coo_to_ell(coo)), tp.CPU)
    for fmt, host in zip(placed, (bell, TF.coo_to_ell(coo))):
        for f in TF.ARRAY_FIELDS[type(fmt)]:
            t = getattr(fmt, f)
            assert isinstance(t, torch.Tensor) and t.device == tp.CPU
            tp.assert_bytes_equal(getattr(host, f), t)
        static = {f.name for f in dataclasses.fields(fmt)} - set(
            TF.ARRAY_FIELDS[type(fmt)])
        assert all(getattr(fmt, f) == getattr(host, f) for f in static)
