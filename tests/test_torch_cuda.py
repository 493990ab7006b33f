"""The port's CUDA kernels against their plain PyTorch versions, and the
training path's gradients against the CPU's, on the card.  These tests
need a CUDA GPU and nvcc and skip elsewhere; this file
imports neither jax nor repro, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's (tests/test_fused.py): float32
atol = rtol = 1e-4, bfloat16 atol = 2e-1, rtol = 3e-1.  dW, float32 on
both sides for either input dtype, is held to 1e-5 of its largest entry
(from unit-scale cotangents): only the order of float32 sums differs.
flash_attention is held to the reference's own flash tolerances
(tests/test_kernels_flash.py): float32 atol 2e-5, rtol 1e-4; bfloat16
atol = rtol = 5e-2.  rwkv6_chunked is held to the reference's RWKV-6
tolerances (tests/test_kernels_rwkv6.py): float32 atol 5e-4 / rtol 1e-3,
against its plain version run in float64 (at w near 1 over long sequences
the float32 oracle's own rounding reaches the tolerance); bfloat16
atol = rtol = 5e-2 against the plain version, and per output row
rms(err) <= 1e-2 rms(plain).  mamba_scan is held to the reference's
tolerance (tests/test_kernels_mamba.py), float32 atol = rtol = 1e-4,
against its plain version run in float64."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import pytest
import torch

from repro_torch.kernels import bell_spmm as bell_mod
from repro_torch.kernels import bell_spmm_fused as bellf_mod
from repro_torch.kernels import block_diag_spmm as bd_mod
from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import mamba_scan as ms_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_chunked as rk_mod
from repro_torch.kernels import tcgnn_tile as tc_mod
from torch_parity import cuda_device  # noqa: F401  (fixture)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_cuda_kernels_match_plain(cuda_device, dtype, B):  # noqa: F811
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    gen = torch.Generator(device=cuda_device).manual_seed(B)
    for F in (3, 16, 500):
        blocks = torch.randn((20, B, B), generator=gen, device=cuda_device)
        x = torch.randn((20 * B, F), generator=gen, device=cuda_device)
        y_in = torch.randn((20 * B, F), generator=gen, device=cuda_device)
        args = (blocks.to(dtype), x.to(dtype), y_in.to(dtype))
        torch.testing.assert_close(bd_mod.block_diag_spmm(*args).float(),
                                   bd_mod.plain(*args).float(), **tol)
        n_valid = torch.randint(0, 5, (20,), generator=gen,
                                device=cuda_device, dtype=torch.int32)
        valid = torch.arange(4, device=cuda_device)[None, :] < n_valid[:, None]
        bblocks = (torch.randn((20, 4, B, B), generator=gen,
                               device=cuda_device)
                   * valid[:, :, None, None]).to(dtype)
        col_idx = (torch.randint(0, 20, (20, 4), generator=gen,
                                 device=cuda_device, dtype=torch.int32)
                   * valid).to(torch.int32)
        got = bell_mod.bell_spmm(bblocks, col_idx, args[1], args[2],
                                 n_valid=n_valid)
        torch.testing.assert_close(
            got.float(), bell_mod.plain(bblocks, col_idx, args[1],
                                        args[2]).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_cuda_block_diag_spmm_widths_seeds_and_alignment(cuda_device, dtype,
                                                        B):  # noqa: F811
    """block_diag_spmm against its plain version at F on both sides of its
    kernels' limits (64 columns, 16-byte vectors), y_in none, full and one
    bias row repeated (strides (0, 1)), both reads, nb = 1 and nb not a
    multiple of the blocks a CTA takes, x on and off 16-byte boundaries;
    two calls give the same bits."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(200 + B)
    for nb in (1, 7, 20):
        n = nb * B
        blocks = torch.randn((nb, B, B), generator=gen, device=dev).to(dtype)
        for F in (1, 3, 5, 16, 17, 64, 65, 500):
            buf = torch.randn((n * F + 1,), generator=gen,
                              device=dev).to(dtype)
            y_ins = (None,
                     torch.randn((n, F), generator=gen, device=dev).to(dtype),
                     torch.randn((F,), generator=gen, device=dev).to(dtype)
                     .expand(n, F))
            for x in (buf[:-1].view(n, F), buf[1:].view(n, F)):
                for y_in in y_ins:
                    for transpose in (False, True):
                        got = bd_mod.block_diag_spmm(blocks, x, y_in,
                                                     transpose=transpose)
                        again = bd_mod.block_diag_spmm(blocks, x, y_in,
                                                       transpose=transpose)
                        want = bd_mod.plain(blocks, x, y_in,
                                            transpose=transpose)
                        torch.cuda.synchronize()
                        assert torch.equal(got, again)
                        torch.testing.assert_close(got.float(), want.float(),
                                                   **tol)


DW_REL_TOL = 1e-5


def _close_dw(got, want):
    """max|got - want| <= DW_REL_TOL * max|want|, same dtype and shape."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max())
    assert err <= DW_REL_TOL * float(want.abs().max()), err


def _synthetic_bell(gen, B: int, dev, nbr: int = 20, K: int = 4):
    """A random blocked-ELL payload honouring the format's contract:
    n_valid[i] leading slots hold blocks, the rest are zero blocks that
    point at block column 0."""
    n_valid = torch.randint(0, K + 1, (nbr,), generator=gen, device=dev,
                            dtype=torch.int32)
    valid = torch.arange(K, device=dev)[None, :] < n_valid[:, None]
    blocks = (torch.randn((nbr, K, B, B), generator=gen, device=dev)
              * valid[:, :, None, None])
    col_idx = (torch.randint(0, nbr, (nbr, K), generator=gen, device=dev,
                             dtype=torch.int32) * valid).to(torch.int32)
    return blocks, col_idx, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_cuda_fused_and_dw_kernels_match_plain(cuda_device, dtype, B):  # noqa: F811
    """block_diag_spmm (transposed read), block_diag_spmm_fused,
    bell_spmm_fused and bell_spmm_dw against their plain versions, at the
    main path's widths (Fi, Fo) in {(500, 16), (16, 3), (3, 16)}."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(100 + B)
    nb = 20
    blocks = torch.randn((nb, B, B), generator=gen, device=dev).to(dtype)
    bblocks, col_idx, n_valid = _synthetic_bell(gen, B, dev, nbr=nb)
    bblocks = bblocks.to(dtype)

    def close(got, want):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)

    x16 = torch.randn((nb * B, 16), generator=gen, device=dev).to(dtype)
    for transpose in (False, True):
        close(bd_mod.block_diag_spmm(blocks, x16, transpose=transpose),
              bd_mod.plain(blocks, x16, transpose=transpose))
    for Fi, Fo in ((500, 16), (16, 3), (3, 16)):
        x = torch.randn((nb * B, Fi), generator=gen, device=dev).to(dtype)
        w = (torch.randn((Fi, Fo), generator=gen, device=dev)
             / Fi ** 0.5).to(dtype)
        g = torch.randn((nb * B, Fo), generator=gen, device=dev).to(dtype)
        for y_in in (None, torch.randn((nb * B, Fo), generator=gen,
                                       device=dev).to(dtype)):
            for transpose in (False, True):
                close(bdf_mod.block_diag_spmm_fused(blocks, x, w, y_in,
                                                    transpose=transpose),
                      bdf_mod.plain(blocks, x, w, y_in, transpose=transpose))
            close(bellf_mod.bell_spmm_fused(bblocks, col_idx, x, w, y_in,
                                            n_valid=n_valid),
                  bellf_mod.plain(bblocks, col_idx, x, w, y_in))
        _close_dw(bellf_mod.bell_spmm_dw(bblocks, col_idx, x, g,
                                         n_valid=n_valid),
                  bellf_mod.plain_dw(bblocks, col_idx, x, g))
        _close_dw(bellf_mod.bell_spmm_dw(blocks.unsqueeze(1), None, x, g,
                                         transpose=True),
                  bellf_mod.plain_dw(blocks.unsqueeze(1), None, x, g,
                                     transpose=True))


@pytest.mark.cuda
def test_cuda_dw_is_deterministic(cuda_device):  # noqa: F811
    """bell_spmm_dw sums its block rows in a fixed order (no atomics), so
    two runs give the same bits, over the transpose payload and over the
    diagonal, at a row count that is not a multiple of the split size."""
    nbr = 307
    assert nbr % bellf_mod.DW_ROWS_PER_SPLIT
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    blocks, col_idx, n_valid = _synthetic_bell(gen, 16, cuda_device,
                                               nbr=nbr, K=6)
    x = torch.randn((nbr * 16, 500), generator=gen, device=cuda_device)
    g = torch.randn((nbr * 16, 16), generator=gen, device=cuda_device)
    a = bellf_mod.bell_spmm_dw(blocks, col_idx, x, g, n_valid=n_valid)
    b = bellf_mod.bell_spmm_dw(blocks, col_idx, x, g, n_valid=n_valid)
    assert torch.equal(a, b)
    _close_dw(a, bellf_mod.plain_dw(blocks, col_idx, x, g))
    diag = blocks[:, :1].contiguous()
    a = bellf_mod.bell_spmm_dw(diag, None, x, g, transpose=True)
    b = bellf_mod.bell_spmm_dw(diag, None, x, g, transpose=True)
    assert torch.equal(a, b)
    _close_dw(a, bellf_mod.plain_dw(diag, None, x, g, transpose=True))


def _ragged_bell(gen, B: int, dev, nbr: int = 24, K: int = 83,
                 n_col_blocks: int = 40):
    """A blocked-ELL payload with one row of K real blocks, two empty rows
    and the rest at 1-4 blocks, naming n_col_blocks > nbr block columns;
    padding slots are zero blocks that point at block column 0.  Block
    entries are N(0, 1 / B), the scale of a degree-normalised adjacency:
    at unit scale the long row sums K * B unit terms (5312 at B = 64),
    whose float32 rounding alone (the plain version against float64, 0.48
    of the tolerance on the CPU) leaves no room for a second summation
    order under atol 1e-4."""
    n_valid = torch.randint(1, 5, (nbr,), generator=gen, device=dev,
                            dtype=torch.int32)
    n_valid[0] = K
    n_valid[1:3] = 0
    valid = torch.arange(K, device=dev)[None, :] < n_valid[:, None]
    blocks = (torch.randn((nbr, K, B, B), generator=gen, device=dev)
              * valid[:, :, None, None] / B ** 0.5)
    col_idx = (torch.randint(0, n_col_blocks, (nbr, K), generator=gen,
                             device=dev, dtype=torch.int32)
               * valid).to(torch.int32)
    return blocks, col_idx, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Fi", [3, 17, 500, 1100])
@pytest.mark.parametrize("Fo", [1, 3, 16, 64, 65])
def test_cuda_fused_kernels_ragged_payloads(cuda_device, dtype, Fi, Fo):  # noqa: F811
    """bell_spmm_fused, block_diag_spmm_fused (both reads) and bell_spmm_dw
    (transpose payload and diagonal) against their plain versions on a
    payload with empty rows and one row of 83 blocks beside rows of at
    most 4, x with more block columns than block rows, at widths that
    give 16-, 8-, 4- and 2-byte copies and ragged tiles, for B in {5, 16,
    64} (both of bell_spmm_fused's kernels); Fi = 1100 streams W through
    the wide kernel (float32) and takes three Fi tiles of dW.  The forward
    and dW give the same bits twice."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(1000 + 7 * Fi + Fo)
    nbr, n_cols = 24, 40

    def close(got, want):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)

    for B in (5, 16, 64):
        blocks, col_idx, n_valid = _ragged_bell(gen, B, dev, nbr=nbr,
                                                n_col_blocks=n_cols)
        blocks = blocks.to(dtype)
        x = torch.randn((n_cols * B, Fi), generator=gen, device=dev).to(dtype)
        w = (torch.randn((Fi, Fo), generator=gen, device=dev)
             / Fi ** 0.5).to(dtype)
        y_in = torch.randn((nbr * B, Fo), generator=gen, device=dev).to(dtype)
        for yi in (None, y_in):
            got = bellf_mod.bell_spmm_fused(blocks, col_idx, x, w, yi,
                                            n_valid=n_valid)
            close(got, bellf_mod.plain(blocks, col_idx, x, w, yi))
            assert torch.equal(got, bellf_mod.bell_spmm_fused(
                blocks, col_idx, x, w, yi, n_valid=n_valid))
            diag = blocks[:, 0].contiguous()
            for transpose in (False, True):
                close(bdf_mod.block_diag_spmm_fused(
                    diag, x[:nbr * B], w, yi, transpose=transpose),
                    bdf_mod.plain(diag, x[:nbr * B], w, yi,
                                  transpose=transpose))
        xr = torch.randn((nbr * B, Fi), generator=gen, device=dev).to(dtype)
        g = torch.randn((n_cols * B, Fo), generator=gen, device=dev).to(dtype)
        got = bellf_mod.bell_spmm_dw(blocks, col_idx, xr, g, n_valid=n_valid)
        _close_dw(got, bellf_mod.plain_dw(blocks, col_idx, xr, g))
        assert torch.equal(got, bellf_mod.bell_spmm_dw(
            blocks, col_idx, xr, g, n_valid=n_valid))
        d1 = blocks[:, :1].contiguous()
        _close_dw(bellf_mod.bell_spmm_dw(d1, None, xr, g[:nbr * B],
                                         transpose=True),
                  bellf_mod.plain_dw(d1, None, xr, g[:nbr * B],
                                     transpose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag_fused", "bell_fused"),
                                  ("block_diag", "tcgnn_tile"),
                                  ("block_diag_fused", "tcgnn_tile_fused")])
def test_cuda_gradients_match_cpu(cuda_device, plan):  # noqa: F811
    """One loss.backward through the kernels' backward passes on the card
    against the same on the CPU (plain versions), from the same
    parameters."""
    from repro_torch.core import adaptgear, gnn
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("pubmed", 0.03, seed=0, comm_size=8,
                                max_feat=32)
    cfg = gnn.GNNConfig(hidden=8, n_layers=2, comm_size=8,
                        selector="fixed", fixed_kernels=plan)
    params = gnn.init_model(torch.Generator().manual_seed(0), cfg,
                            g.features.shape[1], g.n_classes, device="cpu")
    grads = {}
    for dev in ("cpu", cuda_device):
        dec = gnn.prepare(g, cfg, device=dev)
        x = adaptgear.to_reordered(dec, torch.from_numpy(g.features).to(dev))
        leaves = [{k: v.detach().clone().to(dev).requires_grad_()
                   for k, v in p.items()} for p in params]
        y = gnn.forward(leaves, cfg, dec, x, plan)
        (y.square().sum() * 1e-2).backward()
        grads[str(dev)] = [{k: v.grad.cpu() for k, v in p.items()}
                           for p in leaves]
    for gc, gg in zip(grads["cpu"], grads[str(cuda_device)]):
        for k in gc:
            torch.testing.assert_close(gg[k], gc[k], **tp.F32_TOL)


def _synthetic_tcgnn(gen, B: int, dev, nbr: int = 20, C: int = 256):
    """Random condensed tiles (about 30 % non-zero) and gather rows."""
    tiles = (torch.randn((nbr, B, C), generator=gen, device=dev)
             * (torch.rand((nbr, B, C), generator=gen, device=dev) < 0.3))
    gi = torch.randint(0, nbr * B, (nbr, C), generator=gen, device=dev,
                       dtype=torch.int32)
    return tiles, gi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_cuda_tcgnn_kernels_match_plain(cuda_device, dtype, B):  # noqa: F811
    """tcgnn_spmm at F in {3, 16, 500}, tcgnn_spmm_fused at the main
    path's (Fi, Fo) and tcgnn_spmm_dw against their plain versions, with
    and without y_in."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(200 + B)
    tiles, gi = _synthetic_tcgnn(gen, B, dev)
    n = tiles.shape[0] * B

    def close(got, want):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)

    for F in (3, 16, 500):
        x = torch.randn((n, F), generator=gen, device=dev).to(dtype)
        for y_in in (None, torch.randn((n, F), generator=gen,
                                       device=dev).to(dtype)):
            close(tc_mod.tcgnn_spmm(tiles, gi, x, y_in),
                  tc_mod.plain(tiles, gi, x, y_in))
    for Fi, Fo in ((500, 16), (16, 3), (3, 16)):
        x = torch.randn((n, Fi), generator=gen, device=dev).to(dtype)
        w = (torch.randn((Fi, Fo), generator=gen, device=dev)
             / Fi ** 0.5).to(dtype)
        g = torch.randn((n, Fo), generator=gen, device=dev).to(dtype)
        for y_in in (None, torch.randn((n, Fo), generator=gen,
                                       device=dev).to(dtype)):
            close(tc_mod.tcgnn_spmm_fused(tiles, gi, x, w, y_in),
                  tc_mod.plain_fused(tiles, gi, x, w, y_in))
        _close_dw(tc_mod.tcgnn_spmm_dw(tiles, gi, x, g),
                  tc_mod.plain_dw(tiles, gi, x, g))


def _real_slot_tcgnn(gen, B: int, dev, nbr: int = 12, C: int = 256):
    """A payload whose block rows differ in real slots (those up to the
    last tile column with a non-zero; the rest zero and pointing at row
    0): row 0 has none, row 1 uses all C, row 2 holds one non-zero, in its
    last slot, and the other rows random counts with about 30 % non-zero
    inside them.  Returns tiles, gather_idx and the counts."""
    counts = torch.randint(1, C, (nbr,), generator=gen, device=dev)
    counts[0], counts[1], counts[2] = 0, C, C
    live = torch.arange(C, device=dev)[None, :] < counts[:, None]
    tiles = (torch.randn((nbr, B, C), generator=gen, device=dev)
             * (torch.rand((nbr, B, C), generator=gen, device=dev) < 0.3)
             * live[:, None, :])
    tiles[2] = 0.0
    rows = torch.arange(1, nbr, device=dev)
    tiles[rows, rows % B, counts[1:] - 1] = 1.5   # each last real slot
    gi = (torch.randint(0, nbr * B, (nbr, C), generator=gen, device=dev,
                        dtype=torch.int32) * live).to(torch.int32)
    return tiles, gi, counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_cuda_tcgnn_fused_skips_padded_slots(cuda_device, dtype, B):  # noqa: F811
    """tcgnn_spmm_fused walks only a row's real slots: on payloads whose
    rows have none, all C, one non-zero in the last slot, or a random
    count, it matches its plain version at Fi = 500 (the wide kernel;
    bfloat16 rows of 1000 bytes take 8-byte copies) and at the narrow
    widths, with and without y_in, and gives the same bits twice."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(300 + B)
    tiles, gi, counts = _real_slot_tcgnn(gen, B, dev)
    assert torch.equal(tc_mod.real_slots(tiles), counts)
    n = tiles.shape[0] * B
    for Fi, Fo in ((500, 16), (16, 3), (3, 16)):
        x = torch.randn((n, Fi), generator=gen, device=dev).to(dtype)
        w = (torch.randn((Fi, Fo), generator=gen, device=dev)
             / Fi ** 0.5).to(dtype)
        for y_in in (None, torch.randn((n, Fo), generator=gen,
                                       device=dev).to(dtype)):
            got = tc_mod.tcgnn_spmm_fused(tiles, gi, x, w, y_in)
            again = tc_mod.tcgnn_spmm_fused(tiles, gi, x, w, y_in)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            torch.testing.assert_close(
                got.float(), tc_mod.plain_fused(tiles, gi, x, w,
                                                y_in).float(), **tol)


def _unaligned(x):
    """A contiguous copy of x whose data starts one element past an
    allocation's start (4 bytes for float32, 2 for bfloat16)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
@pytest.mark.parametrize("C", [128, 256])
def test_cuda_tcgnn_spmm_skips_padded_slots(cuda_device, dtype, B, C):  # noqa: F811
    """tcgnn_spmm walks only a row's real slots: on payloads whose rows
    have none, all C, one non-zero in the last slot, or a random count
    (C = 128 is one staged chunk at B <= 16; C = 256 and B = 64 are counted
    from device memory and walked in chunks), it matches its plain version
    at F in {3, 16, 500} (one column tile, and 16), over x and over an
    unaligned copy of it, with and without y_in, and gives the same bits
    twice."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(500 + B + C)
    tiles, gi, counts = _real_slot_tcgnn(gen, B, dev, C=C)
    assert torch.equal(tc_mod.real_slots(tiles), counts)
    n = tiles.shape[0] * B
    for F in (3, 16, 500):
        x = torch.randn((n, F), generator=gen, device=dev).to(dtype)
        for xx in (x, _unaligned(x)):
            for y_in in (None, torch.randn((n, F), generator=gen,
                                           device=dev).to(dtype)):
                got = tc_mod.tcgnn_spmm(tiles, gi, xx, y_in)
                again = tc_mod.tcgnn_spmm(tiles, gi, xx, y_in)
                torch.cuda.synchronize()
                assert torch.equal(got, again), (F, y_in is None)
                torch.testing.assert_close(
                    got.float(), tc_mod.plain(tiles, gi, x, y_in).float(),
                    **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 32, 64])
def test_cuda_dual_kernel_ragged_shapes(cuda_device, dtype, B):  # noqa: F811
    """block_diag_spmm_dual against its plain version where its launch
    shapes have edges: 23 blocks (a part-full last row tile) and 600 (the
    persistent CTAs walk several tiles each); Fi % 4 != 0 on both kernels
    (17, 501), Fo > 64 (130), weight stripes too wide to stage once (1500);
    x as given and as an unaligned copy; with and without y_in; the same
    bits on a second call."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(600 + B)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = [(23, Fi, Fo) for Fi, Fo in ((500, 16), (16, 3), (3, 16),
                                          (17, 5), (501, 16), (70, 130),
                                          (1500, 16))]
    cases += [(600, 500, 16), (600, 16, 3)]
    for nb, Fi, Fo in cases:
        blocks = randn(nb, B, B)
        x = randn(nb * B, Fi)
        w, ws = randn(Fi, Fo) / Fi ** 0.5, randn(Fi, Fo) / Fi ** 0.5
        for xx in (x, _unaligned(x)):
            for y_in in (None, randn(nb * B, Fo)):
                got = bdf_mod.block_diag_spmm_dual(blocks, xx, w, ws, y_in)
                again = bdf_mod.block_diag_spmm_dual(blocks, xx, w, ws, y_in)
                torch.cuda.synchronize()
                assert torch.equal(got, again), (nb, Fi, Fo)
                torch.testing.assert_close(
                    got.float(), bdf_mod.plain_dual(blocks, x, w, ws,
                                                    y_in).float(), **tol)


@pytest.mark.cuda
def test_cuda_tcgnn_dw_is_deterministic(cuda_device):  # noqa: F811
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    tiles, gi = _synthetic_tcgnn(gen, 16, cuda_device, nbr=300, C=128)
    x = torch.randn((300 * 16, 500), generator=gen, device=cuda_device)
    g = torch.randn((300 * 16, 16), generator=gen, device=cuda_device)
    a = tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)
    b = tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)
    assert torch.equal(a, b)
    _close_dw(a, tc_mod.plain_dw(tiles, gi, x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [5, 8, 16, 32, 64])
def test_cuda_bell_spmm_ragged_payloads(cuda_device, dtype, B):  # noqa: F811
    """bell_spmm against its plain version on a payload with empty rows and
    one row of 83 blocks beside rows of at most 4, naming more block
    columns than it has block rows, at widths that take the whole of F in
    one tile (1, 3, 16, 17, 64) and several tiles (65, 500): with and
    without y_in, with n_valid and with every slot walked; the same bits on
    a second call."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    gen = torch.Generator(device=cuda_device).manual_seed(30 + B)
    nbr, n_cols = 24, 40
    blocks, col_idx, n_valid = _ragged_bell(gen, B, cuda_device, nbr=nbr,
                                            n_col_blocks=n_cols)
    blocks = blocks.to(dtype)
    for F in (1, 3, 16, 17, 64, 65, 500):
        x = torch.randn((n_cols * B, F), generator=gen,
                        device=cuda_device).to(dtype)
        y_in = torch.randn((nbr * B, F), generator=gen,
                           device=cuda_device).to(dtype)
        for yi, nv in ((None, n_valid), (y_in, n_valid), (y_in, None)):
            got = bell_mod.bell_spmm(blocks, col_idx, x, yi, n_valid=nv)
            again = bell_mod.bell_spmm(blocks, col_idx, x, yi, n_valid=nv)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (F, yi is None, nv is None)
            torch.testing.assert_close(
                got.float(), bell_mod.plain(blocks, col_idx, x, yi).float(),
                **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_cuda_tcgnn_dw_skips_padded_slots(cuda_device, dtype, B):  # noqa: F811
    """tcgnn_spmm_dw walks only a row's real slots: on payloads whose rows
    have none, all C, one non-zero in the last slot, or a random count, dW
    is within 1e-5 of max|dW| of its plain version at (500, 16), (16, 3),
    (3, 16) and (1100, 65), and the same bits on a second call."""
    gen = torch.Generator(device=cuda_device).manual_seed(40 + B)
    tiles, gi, counts = _real_slot_tcgnn(gen, B, cuda_device)
    assert torch.equal(tc_mod.real_slots(tiles), counts)
    n = tiles.shape[0] * B
    for Fi, Fo in ((500, 16), (16, 3), (3, 16), (1100, 65)):
        x = torch.randn((n, Fi), generator=gen, device=cuda_device).to(dtype)
        g = torch.randn((n, Fo), generator=gen, device=cuda_device).to(dtype)
        got = tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)
        again = tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (Fi, Fo)
        _close_dw(got, tc_mod.plain_dw(tiles, gi, x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [8, 16, 32, 64])
def test_cuda_dual_kernel_matches_plain(cuda_device, dtype, B):  # noqa: F811
    """block_diag_spmm_dual at the main path's SAGE widths, with and
    without y_in, and the dual Function's gradients (from unit-scale
    cotangents) against autograd through the plain version: dX at the
    kernel tolerance, dW and dW_self within 1e-5 of their largest entry,
    the same bits on a second backward."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(300 + B)
    nb = 23                                  # not a multiple of 32 / B
    blocks = torch.randn((nb, B, B), generator=gen, device=dev).to(dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for Fi, Fo in ((500, 16), (16, 3), (3, 16), (70, 130)):
        x = randn(nb * B, Fi)
        w, ws = randn(Fi, Fo) / Fi ** 0.5, randn(Fi, Fo) / Fi ** 0.5
        for y_in in (None, randn(nb * B, Fo)):
            got = bdf_mod.block_diag_spmm_dual(blocks, x, w, ws, y_in)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got.float(), bdf_mod.plain_dual(blocks, x, w, ws,
                                                y_in).float(), **tol)
        if dtype != torch.float32:
            continue
        cot = torch.randn((nb * B, Fo), generator=gen, device=dev)
        grads = []
        for fn in (lambda *a: ops.block_diag_dual_matvec(blocks, *a),
                   lambda *a: ops.block_diag_dual_matvec(blocks, *a),
                   lambda *a: bdf_mod.plain_dual(blocks, *a)):
            leaves = [a.clone().requires_grad_() for a in (x, w, ws)]
            (fn(*leaves) * cot).sum().backward()
            grads.append([a.grad for a in leaves])
        torch.cuda.synchronize()
        torch.testing.assert_close(grads[0][0], grads[2][0], **tol)
        for got, again, want in zip(grads[0][1:], grads[1][1:],
                                    grads[2][1:]):
            assert torch.equal(got, again)
            _close_dw(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block_diag_fused", "tcgnn_tile_fused"),
                                  ("block_diag", "bell")])
def test_cuda_sage_gradients_match_cpu(cuda_device, plan):  # noqa: F811
    """One SAGE loss.backward on the card (acc on by default there: the
    dual kernel on the diagonal tier where the plan has block_diag_fused)
    against the same on the CPU (acc off: the seed path), from the same
    parameters."""
    from repro_torch.core import adaptgear, gnn
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("pubmed", 0.03, seed=0, comm_size=8,
                                max_feat=32)
    cfg = gnn.GNNConfig(model="sage", hidden=8, n_layers=2, comm_size=8,
                        selector="fixed", fixed_kernels=plan)
    params = gnn.init_model(torch.Generator().manual_seed(0), cfg,
                            g.features.shape[1], g.n_classes, device="cpu")
    grads = {}
    before = bdf_mod.dual_launches.value
    for dev in ("cpu", cuda_device):
        dec = gnn.prepare(g, cfg, device=dev)
        x = adaptgear.to_reordered(dec, torch.from_numpy(g.features).to(dev))
        leaves = [{k: v.detach().clone().to(dev).requires_grad_()
                   for k, v in p.items()} for p in params]
        y = gnn.forward(leaves, cfg, dec, x, plan)
        (y.square().sum() * 1e-2).backward()
        grads[str(dev)] = [{k: v.grad.cpu() for k, v in p.items()}
                           for p in leaves]
    torch.cuda.synchronize()
    assert bdf_mod.dual_launches.value - before == (
        2 if plan[0] == "block_diag_fused" else 0)
    for gc, gg in zip(grads["cpu"], grads[str(cuda_device)]):
        for k in gc:
            torch.testing.assert_close(gg[k], gc[k], **tp.F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("structure", ["transform_first", "aggregate_first"])
@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag", "tcgnn_tile"),
                                  ("block_diag_fused", "tcgnn_tile_fused"),
                                  ("block_diag_fused", "bell_fused")])
def test_cuda_gin_matches_cpu(cuda_device, plan, structure):  # noqa: F811
    """GIN on proteins_full's 29 features (rows 116 bytes long, not on
    16-byte boundaries), hidden 64, layer 1 forced to each structure: the
    logits and every gradient (eps included) on the card (acc on: the
    self term seeds the kernels' full (n, 64) y_in) against the CPU's,
    float32 1e-4.  Aggregate-first runs the unfused kernels at F = 29 and
    layer 1 needs no dX pass, so block_diag_spmm launches 3 times, not 4;
    a fused plan runs transform-first (Fi = 29 -> Fo = 64) either way."""
    from repro_torch.core import adaptgear, epilogue, gnn
    from repro_torch.core.plan import KernelPlan
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("proteins_full", 0.03, seed=0, comm_size=16)
    assert g.features.shape[1] == 29
    cfg = gnn.GNNConfig(model="gin", hidden=64, n_layers=2, selector="fixed",
                        fixed_kernels=plan)
    params = gnn.init_model(torch.Generator().manual_seed(0), cfg, 29,
                            g.n_classes, device="cpu")
    params = [dict(p, eps=torch.tensor(0.25)) for p in params]
    eps = (epilogue.gin_layer_spec(29, 64, 64, structure),
           epilogue.gin_layer_spec(64, 64, g.n_classes, "transform_first"))
    out = {}
    before = bd_mod.launches.value
    for dev in ("cpu", cuda_device):
        dec = gnn.prepare(g, cfg, device=dev)
        kplan = KernelPlan.make(dec, plan, n_layers=2, epilogues=eps)
        x = adaptgear.to_reordered(dec, torch.from_numpy(g.features).to(dev))
        leaves = [{k: v.detach().clone().to(dev).requires_grad_()
                   for k, v in p.items()} for p in params]
        y = gnn.forward(leaves, cfg, dec, x, kplan)
        (y.square().sum() * 1e-3).backward()
        out[str(dev)] = (y.detach().cpu(), [{k: v.grad.cpu()
                                             for k, v in p.items()}
                                            for p in leaves])
    torch.cuda.synchronize()
    if plan == ("block_diag", "bell"):
        assert bd_mod.launches.value - before == (
            3 if structure == "aggregate_first" else 4)
    (yc, gc), (yg, gg) = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(yg, yc, **tp.F32_TOL)
    for a, b in zip(gc, gg):
        for k in a:
            torch.testing.assert_close(b[k], a[k], **tp.F32_TOL)


@pytest.mark.cuda
def test_cuda_gin_trains_on_louvain_like_the_cpu(cuda_device):  # noqa: F811
    """gnn.train(model="gin", reorder="louvain") on the card and on the
    CPU from one parameter set: the same permutation, plan and
    structures, curves within atol 5e-3, rtol 1e-2."""
    import numpy as np
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("pubmed", 0.05, seed=0, comm_size=16,
                                max_feat=24)
    cfg = gnn.GNNConfig(model="gin", hidden=32, reorder="louvain",
                        selector="fixed",
                        fixed_kernels=("block_diag_fused", "tcgnn_tile"))
    params = gnn.init_model(torch.Generator().manual_seed(1), cfg, 24,
                            g.n_classes, device="cpu")
    res = {dev: gnn.train(g, cfg, steps=8, device=dev, params=params)
           for dev in ("cpu", cuda_device)}
    rc, rg = res["cpu"], res[cuda_device]
    assert rc.kernels == rg.kernels and rc.plan.epilogues == rg.plan.epilogues
    np.testing.assert_allclose(rg.losses, rc.losses, atol=5e-3, rtol=1e-2)


@pytest.mark.cuda
def test_cuda_feedback_selection_probes_every_candidate(cuda_device):  # noqa: F811
    """select_plan("feedback") on the card times every candidate, the
    tcgnn kernels included, and commits a valid plan."""
    from repro_torch.core import gnn
    from repro_torch.core.plan import KernelPlan
    from repro_torch.graphs import graph as graph_mod
    from repro_torch.kernels.registry import REGISTRY
    g = graph_mod.synth_dataset("pubmed", 0.03, seed=0, comm_size=8,
                                max_feat=32)
    cfg = gnn.GNNConfig(hidden=8, n_layers=2, comm_size=8)
    dec = gnn.prepare(g, cfg, device=cuda_device)
    before = (tc_mod.launches.value, tc_mod.fused_launches.value)
    plan, probes = gnn.select_plan(dec, cfg, [(32, 8), (8, 3)])
    torch.cuda.synchronize()
    assert tc_mod.launches.value > before[0]
    assert tc_mod.fused_launches.value > before[1]
    assert KernelPlan.make(dec, plan).layers == plan.layers
    want = {(s.name, k.name, fo) for s in dec.subgraphs
            for k in REGISTRY.candidates_for(s, include_fused=True)
            for fo in (8, 3)}
    assert set(probes) == want and all(t > 0 for t in probes.values())


FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
# bfloat16 must also hold these (as in chip_smoke.py): at S >= 256 the
# reference's 5e-2 is about as large as a typical output, so it alone
# would pass a kernel that dropped a KV tile or a softmax rescale
FLASH_BF16_TIGHT = dict(atol=4e-3, rtol=2e-2)
FLASH_BF16_ROW_RMS = 1e-2


def assert_flash_close(got, want):
    """At FLASH_TOL; bfloat16 also at FLASH_BF16_TIGHT and, per output
    row, rms(err) <= FLASH_BF16_ROW_RMS * rms(want)."""
    got, want, dtype = got.float(), want.float(), got.dtype
    torch.testing.assert_close(got, want, **FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, **FLASH_BF16_TIGHT)
        row = ((got - want).square().mean(-1).sqrt()
               / want.square().mean(-1).sqrt())
        assert float(row.max()) <= FLASH_BF16_ROW_RMS, float(row.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", [(32, 32), (64, 64), (128, 128),
                                  (192, 128)])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, causal, d,
                                            dv):  # noqa: F811
    """flash_attention against its plain version: GQA groups 1, 2 and 8,
    sequence lengths that are and are not multiples of the kernel's 64-row
    tile, and Sq != Skv (non-causal only: the two causal alignments differ
    there, as in the reference)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + dv)
    cases = [(2, 4, 4, 128, 128), (1, 8, 4, 256, 256), (2, 8, 1, 96, 96),
             (1, 2, 2, 32, 32)]
    if not causal:
        cases.append((1, 4, 2, 64, 256))
    for B, Hq, Hkv, Sq, Skv in cases:
        q = torch.randn((B, Hq, Sq, d), generator=gen, device=cuda_device)
        k = torch.randn((B, Hkv, Skv, d), generator=gen, device=cuda_device)
        v = torch.randn((B, Hkv, Skv, dv), generator=gen, device=cuda_device)
        args = [t.to(dtype) for t in (q, k, v)]
        blk = min(Sq, Skv, 32)
        got = fa_mod.flash_attention(*args, causal=causal, blk_q=blk,
                                     blk_k=blk)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, Hq, Sq, dv)
        assert_flash_close(got, fa_mod.plain(*args, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_cuda_flash_attention_bf16_ragged_and_grouped(cuda_device, d,
                                                      group):  # noqa: F811
    """The bfloat16 tensor-core path (d = dv) where its 128-row query and
    128-key tiles are ragged: Sq not a multiple of 128 (causal and not),
    Sq != Skv with both ragged (non-causal), one query and one key, at
    GQA groups Hq / Hkv of 1, 2 and 4."""
    gen = torch.Generator(device=cuda_device).manual_seed(40 + d + group)
    cases = [(2, 2, 200, 200, True), (1, 2, 200, 200, False),
             (1, 2, 96, 333, False), (2, 1, 333, 96, False),
             (1, 1, 1, 1, True)]
    for B, Hkv, Sq, Skv, causal in cases:
        Hq = Hkv * group
        q, k, v = (torch.randn((B, h, s, d), generator=gen,
                               device=cuda_device).bfloat16()
                   for h, s in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
        got = fa_mod.flash_attention(q, k, v, causal=causal, blk_q=Sq,
                                     blk_k=Skv)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, Sq, d)
        assert_flash_close(got, fa_mod.plain(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_paths_agree(cuda_device, causal):  # noqa: F811
    """bfloat16 with d = dv = 128 takes the tensor-core path when every
    operand is 16-byte aligned and the CUDA-core path otherwise (here:
    views that start one element into their storage); both match the
    plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    shapes = ((2, 8, 192, 128), (2, 2, 192, 128), (2, 2, 192, 128))
    aligned = [torch.randn(s, generator=gen, device=cuda_device).bfloat16()
               for s in shapes]
    shifted = []
    for t in aligned:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        shifted.append(view)
    want = fa_mod.plain(*aligned, causal=causal)
    for args in (aligned, shifted):
        got = fa_mod.flash_attention(*args, causal=causal, blk_q=64,
                                     blk_k=64)
        torch.cuda.synchronize()
        assert_flash_close(got, want)


@pytest.mark.cuda
def test_cuda_flash_attention_counts_launches_and_trains(cuda_device):  # noqa: F811
    """One launch per CUDA call, none for a CPU call; the trainable form's
    gradients (recomputed through plain mha) equal autograd through the
    plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((1, 4, 128, 64), generator=gen,
                           device=cuda_device) for _ in range(3))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    before = fa_mod.launches.value
    fa_mod.flash_attention(q, k, v)
    fa_mod.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert fa_mod.launches.value - before == 1
    cot = torch.randn((1, 4, 128, 64), generator=gen, device=cuda_device)
    grads = []
    for fn in (fa_mod.flash_attention_trainable, fa_mod.plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves, causal=True) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    assert fa_mod.launches.value - before == 2
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **tp.F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["device", "dtype", "float16", "strided",
                                  "head_dim"])
def test_cuda_flash_attention_rejects_bad_operands(cuda_device, case):  # noqa: F811
    q = torch.randn((1, 2, 64, 32), device=cuda_device)
    k = torch.randn((1, 2, 64, 32), device=cuda_device)
    v = torch.randn((1, 2, 64, 32), device=cuda_device)
    if case == "device":
        k = k.cpu()
    elif case == "dtype":
        v = v.bfloat16()
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "strided":
        q = torch.randn((1, 64, 2, 32), device=cuda_device).transpose(1, 2)
    else:
        q, k = (torch.randn((1, 2, 64, 260), device=cuda_device)
                for _ in range(2))
    before = fa_mod.launches.value
    with pytest.raises(ValueError):
        fa_mod.flash_attention(q, k, v)
    assert fa_mod.launches.value == before


RWKV_TOL = {torch.float32: dict(atol=5e-4, rtol=1e-3),
            torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
RWKV_BF16_ROW_RMS = 1e-2


def _rwkv_inputs(gen, B, H, T, dh, dtype, decay, dev):
    """r, k, v ~ N(0, 1) in ``dtype``; w float32 from rates N(0, 1)
    clipped to the model's [-20, 0.405] ("rand"), all at the floor 0.405
    (log w = -1.5) or all at -20 (w within 2e-9 of 1); u float32."""
    r, k, v = (torch.randn((B, H, T, dh), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    rate = {"rand": torch.randn((B, H, T, dh), generator=gen, device=dev)
            .clamp(-20.0, 0.405),
            "floor": torch.full((B, H, T, dh), 0.405, device=dev),
            "one": torch.full((B, H, T, dh), -20.0, device=dev)}[decay]
    u = torch.randn((H, dh), generator=gen, device=dev)
    return r, k, v, torch.exp(-torch.exp(rate)), u


def assert_rwkv_close(got, args):
    """The kernel's output against its plain version: float32 against the
    plain version in float64, bfloat16 against it in bfloat16 plus the
    per-row RMS criterion; finite everywhere."""
    assert torch.isfinite(got).all()
    if got.dtype == torch.float32:
        want = rk_mod.plain(*(a.double() for a in args))
    else:
        want = rk_mod.plain(*args)
    got, want = got.double(), want.double()
    torch.testing.assert_close(got, want, **RWKV_TOL[args[0].dtype])
    if args[0].dtype == torch.bfloat16:
        row = ((got - want).square().mean(-1).sqrt()
               / want.square().mean(-1).sqrt().clamp_min(1e-30))
        assert float(row.max()) <= RWKV_BF16_ROW_RMS, float(row.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["rand", "floor", "one"])
def test_cuda_rwkv6_matches_plain(cuda_device, dtype, decay):  # noqa: F811
    """rwkv6_chunked_kernel against its plain version (the sequential
    oracle): the reference test's shapes and chunks, a ragged last chunk
    (T = 40), head dims 8 and 24 (padded to 32 inside), and RWKV6-7B's
    head dim at chunk 128 over 512 steps."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    cases = [((1, 2, 64, 16), 16), ((2, 2, 128, 64), 32),
             ((1, 3, 40, 8), 8), ((2, 2, 48, 24), 16),
             ((1, 4, 512, 64), 128)]
    for (B, H, T, dh), chunk in cases:
        args = _rwkv_inputs(gen, B, H, T, dh, dtype, decay, cuda_device)
        got = rk_mod.rwkv6_chunked_kernel(*args, chunk=chunk)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (B, H, T, dh)
        assert_rwkv_close(got, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rwkv6_ragged_and_repeatable(cuda_device, dtype):  # noqa: F811
    """The kernel's 16-step chunks and 3-slot copy ring against T that
    neither divides (1030, 1025, 77, 70, 50, 33 steps; 1040 is 65 chunks),
    at each compiled head width (dh 8 and 16 run the 16-wide build, 24 and
    32 the 32-wide one, 40 and 64 the 64-wide one), batch 1 over more than
    1024 steps (a head a CTA, the launch for grids of at most one CTA an
    SM) and 144 heads of 64 (two CTAs an SM); two calls give the same
    bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    cases = [((1, 2, 1040, 64), 8), ((1, 3, 1030, 32), 2),
             ((1, 2, 1025, 8), 5), ((2, 2, 77, 16), 7),
             ((3, 48, 70, 64), 10), ((3, 2, 50, 40), 10),
             ((1, 1, 33, 24), 3)]
    for (B, H, T, dh), chunk in cases:
        for decay in ("rand", "one"):
            args = _rwkv_inputs(gen, B, H, T, dh, dtype, decay, cuda_device)
            got = rk_mod.rwkv6_chunked_kernel(*args, chunk=chunk)
            again = rk_mod.rwkv6_chunked_kernel(*args, chunk=chunk)
            torch.cuda.synchronize()
            assert torch.equal(got, again), ((B, H, T, dh), decay)
            assert_rwkv_close(got, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rwkv6_exact_far_below_the_decay_floor(cuda_device, dtype):  # noqa: F811
    """w far below the model's floor (log w = -e^3, about -20) in every
    other head over steps 48-159: there a chunk's decay falls under 2^-100
    and the kernel forms its pair terms from the log2 sums, elsewhere from
    the product factored at the chunk start; both match the oracle."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    for B, H, T, dh in ((2, 4, 256, 64), (1, 3, 200, 24)):
        r, k, v, w, u = _rwkv_inputs(gen, B, H, T, dh, dtype, "rand",
                                     cuda_device)
        w[:, ::2, 48:160] = float(torch.exp(-torch.exp(torch.tensor(3.0))))
        got = rk_mod.rwkv6_chunked_kernel(r, k, v, w, u, chunk=8)
        torch.cuda.synchronize()
        assert_rwkv_close(got, (r, k, v, w, u))


@pytest.mark.cuda
def test_cuda_rwkv6_exact_where_the_chunked_form_overflows(cuda_device):  # noqa: F811
    """At chunk 128 with every decay at the floor the plain chunked form
    returns NaN (as the reference's does, ROADMAP section 3 fault 7); the
    kernel is finite and matches the oracle, and at chunk 32 the chunked
    form agrees with both."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    args = _rwkv_inputs(gen, 2, 4, 256, 64, torch.float32, "floor",
                        cuda_device)
    o128, _ = rk_mod.rwkv6_chunked(*args, chunk=128)
    assert torch.isnan(o128).any()
    got = rk_mod.rwkv6_chunked_kernel(*args, chunk=128)
    assert_rwkv_close(got, args)
    o32, _ = rk_mod.rwkv6_chunked(*args, chunk=32)
    torch.testing.assert_close(got, o32, **RWKV_TOL[torch.float32])


@pytest.mark.cuda
def test_cuda_rwkv6_counts_launches(cuda_device):  # noqa: F811
    """One launch per CUDA call and none for a CPU call; RWKV6-7B's reduced
    config launches it once per layer in the prefill step under the
    kernel core (T % chunk == 0, T > chunk), never in prefill or decode,
    and its logits match the same step on the CPU."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import steps
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    args = _rwkv_inputs(gen, 1, 2, 64, 16, torch.float32, "rand",
                        cuda_device)
    before = rk_mod.launches.value
    rk_mod.rwkv6_chunked_kernel(*args, chunk=16)
    rk_mod.rwkv6_chunked_kernel(*(a.cpu() for a in args), chunk=16)
    assert rk_mod.launches.value - before == 1
    cfg = dataclasses.replace(configs.get_config("rwkv6_7b", reduced=True),
                              wkv_core="pallas")
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    card_params = lm._tree_map(lambda a: a.to(cuda_device), params)
    before = rk_mod.launches.value
    card = steps.make_prefill_step(cfg)(card_params,
                                        dict(tokens=toks.to(cuda_device)))
    torch.cuda.synchronize()
    assert rk_mod.launches.value - before == cfg.n_layers
    cpu = steps.make_prefill_step(cfg)(params, dict(tokens=toks))
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-3, rtol=1e-3)
    before = rk_mod.launches.value
    _, caches = lm.prefill(card_params, cfg,
                           dict(tokens=toks.to(cuda_device)), s_max=33)
    lm.decode_step(card_params, cfg, caches, toks[:, :1].to(cuda_device), 32)
    torch.cuda.synchronize()
    assert rk_mod.launches.value == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["device", "dtype", "float16", "w_bf16",
                                  "strided", "t_chunk", "head_dim"])
def test_cuda_rwkv6_rejects_bad_operands(cuda_device, case):  # noqa: F811
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    r, k, v, w, u = _rwkv_inputs(gen, 1, 2, 64, 32, torch.float32, "rand",
                                 cuda_device)
    chunk = 16
    if case == "device":
        k = k.cpu()
    elif case == "dtype":
        v = v.bfloat16()
    elif case == "float16":
        r, k, v = r.half(), k.half(), v.half()
    elif case == "w_bf16":
        w = w.bfloat16()
    elif case == "strided":
        r = torch.randn((1, 64, 2, 32), device=cuda_device).transpose(1, 2)
    elif case == "t_chunk":
        chunk = 48
    else:
        r, k, v, w = (torch.rand((1, 2, 64, 128), device=cuda_device)
                      for _ in range(4))
        u = torch.randn((2, 128), device=cuda_device)
    before = rk_mod.launches.value
    with pytest.raises(ValueError):
        rk_mod.rwkv6_chunked_kernel(r, k, v, w, u, chunk=chunk)
    assert rk_mod.launches.value == before


MAMBA_TOL = dict(atol=1e-4, rtol=1e-4)       # tests/test_kernels_mamba.py


def _mamba_inputs(gen, B, T, di, ds, dev, dt_scale=0.1):
    """tests/test_kernels_mamba.py's inputs on the card: x, dt = |N| *
    dt_scale, Bc, Cc, A = -(|N| + 0.1), D."""
    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return (n(B, T, di), n(B, T, di).abs() * dt_scale, n(B, T, ds),
            n(B, T, ds), -(n(di, ds).abs() + 0.1), n(di))


@pytest.mark.cuda
@pytest.mark.parametrize("dt_scale", [0.1, 2.0])
def test_cuda_mamba_scan_matches_plain(cuda_device, dt_scale):  # noqa: F811
    """mamba_scan against its plain version (the sequential oracle) in
    float64: the reference test's shapes, chunks and d_tiles; d_state 1
    and 3 (padded inside), d_inner not a multiple of the CTA's 64
    channels, T not a multiple of the 32-step chunk; Jamba's d_state 16
    over 512 steps; and a bfloat16 x (y bfloat16, one rounding, relative
    2^-8, from the oracle: atol 1e-3, rtol 8e-3)."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    cases = [(1, 16, 8, 2, 8, 8), (2, 64, 32, 4, 16, 16),
             (1, 128, 64, 8, 32, 32), (2, 32, 16, 16, 32, 8),
             (2, 40, 72, 1, 40, 72), (1, 96, 200, 3, 32, 200),
             (2, 512, 256, 16, 128, 256)]
    for B, T, di, ds, chunk, d_tile in cases:
        args = _mamba_inputs(gen, B, T, di, ds, cuda_device, dt_scale)
        got = ms_mod.mamba_scan(*args, chunk=chunk, d_tile=d_tile)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (B, T, di)
        x, dt, Bc, Cc, A, D = (a.double() for a in args)
        want = ms_mod.plain(x, dt, A, Bc, Cc, D)
        torch.testing.assert_close(got.double(), want, **MAMBA_TOL)
        xb = args[0].bfloat16()
        got = ms_mod.mamba_scan(xb, *args[1:], chunk=chunk, d_tile=d_tile)
        assert got.dtype == torch.bfloat16
        want = ms_mod.plain(xb.double(), dt, A, Bc, Cc, D)
        torch.testing.assert_close(got.double(), want, atol=1e-3, rtol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cuda_mamba_scan_ragged_and_repeatable(cuda_device, x_dtype):  # noqa: F811
    """The kernel's launch shapes at d_state 16 (64 channels a CTA, 2
    lanes a channel where the grid fills the card, 4 where batch 1 leaves
    it at one CTA an SM; bulk copies where whole 256-byte rows of x line
    up, cp.async otherwise) and its padded d_state 1, 3, 5 and 11, against
    d_inner not a multiple of a CTA's channels (96, 8200, 72, 200, 40), T
    not a multiple of its 16-step chunk (4100, 70, 50, 45, 37), batch 1
    over 4096 steps; two calls give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    cases = [(1, 4096, 96, 16), (1, 4100, 128, 16), (3, 70, 8256, 16),
             (2, 70, 8200, 16), (3, 50, 72, 1), (2, 45, 200, 3),
             (2, 37, 40, 5), (1, 64, 136, 11)]
    tol = (MAMBA_TOL if x_dtype == torch.float32
           else dict(atol=1e-3, rtol=8e-3))
    for B, T, di, ds in cases:
        args = _mamba_inputs(gen, B, T, di, ds, cuda_device)
        x = args[0].to(x_dtype)
        got = ms_mod.mamba_scan(x, *args[1:], chunk=T, d_tile=di)
        again = ms_mod.mamba_scan(x, *args[1:], chunk=T, d_tile=di)
        torch.cuda.synchronize()
        assert got.dtype == x_dtype and got.shape == (B, T, di)
        assert torch.equal(got, again), (B, T, di, ds)
        dt, Bc, Cc, A, D = (a.double() for a in args[1:])
        want = ms_mod.plain(x.double(), dt, A, Bc, Cc, D)
        torch.testing.assert_close(got.double(), want, **tol)


@pytest.mark.cuda
def test_cuda_mamba_scan_counts_launches(cuda_device):  # noqa: F811
    """One launch per CUDA call and none for a CPU call; Jamba's reduced
    config under the serving profile launches it at the 7 Mamba layers of
    each period in the prefill step and in prefill, never in decode, and
    its logits match the same on the CPU (1e-3)."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import steps
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    args = _mamba_inputs(gen, 1, 64, 32, 4, cuda_device)
    before = ms_mod.launches.value
    ms_mod.mamba_scan(*args)
    ms_mod.mamba_scan(*(a.cpu() for a in args))
    assert ms_mod.launches.value - before == 1
    cfg = dataclasses.replace(configs.get_config("jamba_v0_1_52b",
                                                 reduced=True),
                              mamba_core="pallas", attn_core="flash")
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)).astype(np.int32))
    card_params = lm._tree_map(lambda a: a.to(cuda_device), params)
    before = ms_mod.launches.value
    card = steps.make_prefill_step(cfg)(card_params,
                                        dict(tokens=toks.to(cuda_device)))
    torch.cuda.synchronize()
    assert ms_mod.launches.value - before == 7
    cpu = steps.make_prefill_step(cfg)(params, dict(tokens=toks))
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-3, rtol=1e-3)
    before = ms_mod.launches.value
    lg, caches = lm.prefill(card_params, cfg,
                            dict(tokens=toks.to(cuda_device)), s_max=129)
    assert ms_mod.launches.value - before == 7
    torch.testing.assert_close(lg.cpu(), cpu, atol=1e-3, rtol=1e-3)
    lm.decode_step(card_params, cfg, caches, toks[:, :1].to(cuda_device),
                   128)
    torch.cuda.synchronize()
    assert ms_mod.launches.value - before == 7


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["device", "float16", "dt_bf16", "strided",
                                  "t_chunk", "d_state"])
def test_cuda_mamba_scan_rejects_bad_operands(cuda_device, case):  # noqa: F811
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x, dt, Bc, Cc, A, D = _mamba_inputs(gen, 1, 64, 32, 4, cuda_device)
    chunk = 16
    if case == "device":
        Bc = Bc.cpu()
    elif case == "float16":
        x = x.half()
    elif case == "dt_bf16":
        dt = dt.bfloat16()
    elif case == "strided":
        x = torch.randn((1, 32, 64), device=cuda_device).transpose(1, 2)
    elif case == "t_chunk":
        chunk = 48
    else:
        x, dt, Bc, Cc, A, D = _mamba_inputs(gen, 1, 64, 32, 17, cuda_device)
    before = ms_mod.launches.value
    with pytest.raises(ValueError):
        ms_mod.mamba_scan(x, dt, Bc, Cc, A, D, chunk=chunk)
    assert ms_mod.launches.value == before


# --- GAT, mean/max aggregation, several inter buckets, the dense MoE ------

@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag_fused", "tcgnn_tile_fused")])
def test_cuda_gcn_trains_on_four_inter_buckets_like_the_cpu(
        cuda_device, plan):  # noqa: F811
    """GCN on a fixed inter_buckets=4 decomposition: the hand kernels run
    over each of the four inter tiers, one inter-kernel launch per bucket
    where the plan launches one for a single tier; the curve on the card
    matches the CPU's (atol 5e-3, rtol 1e-2) and the same plan's at k = 1."""
    import dataclasses
    import numpy as np
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("pubmed", 0.05, seed=0, comm_size=16,
                                max_feat=24)
    cfg = gnn.GNNConfig(hidden=16, inter_buckets=4, selector="fixed",
                        fixed_kernels=plan)
    params = gnn.init_model(torch.Generator().manual_seed(2), cfg, 24,
                            g.n_classes, device="cpu")
    inter = {"bell": bell_mod.launches,
             "tcgnn_tile_fused": tc_mod.fused_launches}[plan[1]]
    before = inter.value
    steps = 6
    res = gnn.train(g, cfg, steps=steps, device=cuda_device, params=params)
    torch.cuda.synchronize()
    k = len(res.plan.layers[0]) - 1
    assert k == 4
    # per layer and bucket: unfused forward + backward; fused forward, and
    # the dX pass for layer 2; plus one forward of both layers
    per_step = 4 * k if plan[1] == "bell" else 3 * k
    assert inter.value - before == steps * per_step + 2 * k
    cpu = gnn.train(g, cfg, steps=steps, device="cpu", params=params)
    one = gnn.train(g, dataclasses.replace(cfg, inter_buckets=1),
                    steps=steps, device=cuda_device, params=params)
    np.testing.assert_allclose(res.losses, cpu.losses, atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(res.losses, one.losses, atol=5e-3, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag", "tcgnn_tile")])
def test_cuda_mean_and_max_aggregation_match_cpu(cuda_device, plan):  # noqa: F811
    """aggregate_mean through the hand kernels (acc on, the card's
    default) and aggregate_max with its gradient (integer-valued features:
    tied maxima), at inter_buckets 2, against the same on the CPU: float32
    1e-4, and the max and its gradient equal."""
    import numpy as np
    from repro_torch.core import adaptgear, gnn
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("pubmed", 0.05, seed=0, comm_size=16,
                                max_feat=8)
    cfg = gnn.GNNConfig(model="gat", inter_buckets=2, selector="fixed")
    decs = {dev: gnn.prepare(g, cfg, device=dev)
            for dev in ("cpu", cuda_device)}
    dec = decs["cpu"]
    deg = np.bincount(g.receivers, minlength=g.n).astype(np.float32)
    inv = np.zeros(dec.n_pad, np.float32)
    inv[dec.perm.numpy()] = 1.0 / np.maximum(deg, 1.0)
    rng = np.random.default_rng(0)
    names = (plan[0],) + (plan[1],) * (len(dec.subgraphs) - 1)
    before = bd_mod.launches.value
    for F in (16, 500):
        x = torch.from_numpy(rng.standard_normal((dec.n_pad, F)).astype(
            np.float32))
        want = adaptgear.aggregate_mean(dec, x, torch.from_numpy(inv), names)
        got = adaptgear.aggregate_mean(decs[cuda_device], x.to(cuda_device),
                                       torch.from_numpy(inv).to(cuda_device),
                                       names)
        torch.testing.assert_close(got.cpu(), want, **tp.F32_TOL)
        xi = torch.from_numpy(rng.integers(-3, 4, (dec.n_pad, F)).astype(
            np.float32))
        out = {}
        for dev in ("cpu", cuda_device):
            leaf = xi.to(dev).detach().requires_grad_()
            y = adaptgear.aggregate_max(decs[dev], leaf)
            y.sum().backward()
            out[str(dev)] = (y.detach().cpu(), leaf.grad.cpu())
        torch.testing.assert_close(out[str(cuda_device)][0], out["cpu"][0],
                                   atol=0, rtol=0)
        torch.testing.assert_close(out[str(cuda_device)][1], out["cpu"][1],
                                   atol=1e-6, rtol=0)
    torch.cuda.synchronize()
    assert bd_mod.launches.value - before == 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_cuda_gat_matches_cpu(cuda_device, k):  # noqa: F811
    """One GAT forward and backward on the card against the CPU, from the
    same parameters: logits and every gradient (w, a_dst, a_src, b) within
    float32 1e-4, all finite; GAT launches no hand kernel."""
    from repro_torch.core import adaptgear, gnn
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("pubmed", 0.05, seed=0, comm_size=16,
                                max_feat=32)
    cfg = gnn.GNNConfig(model="gat", hidden=16, inter_buckets=k,
                        selector="fixed")
    params = gnn.init_model(torch.Generator().manual_seed(0), cfg, 32,
                            g.n_classes, device="cpu")
    params = [dict(p, b=torch.linspace(-0.1, 0.1, p["b"].shape[0]))
              for p in params]
    before = (bd_mod.launches.value, bell_mod.launches.value)
    out = {}
    for dev in ("cpu", cuda_device):
        dec = gnn.prepare(g, cfg, device=dev)
        x = adaptgear.to_reordered(dec, torch.from_numpy(g.features).to(dev))
        leaves = [{key: v.detach().clone().to(dev).requires_grad_()
                   for key, v in p.items()} for p in params]
        y = gnn.forward(leaves, cfg, dec, x, ("block_diag", "bell"))
        (y.square().sum() * 1e-2).backward()
        out[str(dev)] = (y.detach().cpu(), [{key: v.grad.cpu()
                                             for key, v in p.items()}
                                            for p in leaves])
    torch.cuda.synchronize()
    assert (bd_mod.launches.value, bell_mod.launches.value) == before
    (yc, gc), (yg, gg) = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(yg, yc, **tp.F32_TOL)
    for a, b in zip(gc, gg):
        for key in a:
            assert bool(torch.isfinite(b[key]).all())
            torch.testing.assert_close(b[key], a[key], **tp.F32_TOL)


@pytest.mark.cuda
def test_cuda_moe_dense_bf16_keeps_float32_expert_sums(cuda_device):  # noqa: F811
    """bf16 moe_apply_dense on the card: bmm_f32 returns float32 sums
    (within 1e-5 of max|y| of the float64 products of the bf16 operands),
    and at least 98 % of the bf16 outputs equal the float32-sum reference
    rounded to bf16 (a product rounded to bf16 before the combine reads
    about two thirds)."""
    from repro_torch.models import blocks as blk
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cfg = blk.MoEConfig(d_model=64, n_experts=4, top_k=2, d_ff_expert=160)
    p = blk.init_moe(gen, cfg, torch.bfloat16)
    h = torch.randn((4, 96, 160), generator=gen,
                    device=cuda_device).bfloat16()
    y = blk.bmm_f32(h, p["w_down"])
    assert y.dtype == torch.float32
    want = torch.bmm(h.double(), p["w_down"].double())
    assert float((y.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    x = torch.randn((96, 64), generator=gen, device=cuda_device).bfloat16()
    got, _ = blk.moe_apply_dense(p, cfg, x)
    ref = _moe_dense_f32_sums(blk, p, cfg, x)
    assert got.dtype == torch.bfloat16
    assert float((got == ref.bfloat16()).float().mean()) >= 0.98


def _moe_dense_f32_sums(blk, p, cfg, x):
    """The dense MoE path (its gate and up products as the port forms
    them) with each expert's down product summed in float32 one expert at
    a time (float32 copies of one expert's bf16 weights, exact) and
    combined in float32: the float32-sum reference."""
    top_vals, top_idx, _ = blk._moe_gates(p, cfg, x)
    combine = torch.zeros((x.shape[0], cfg.n_experts), dtype=torch.float32,
                          device=x.device).scatter_add_(1, top_idx, top_vals)
    gate = torch.matmul(x[None], p["w_gate"]).to(x.dtype)
    up = torch.matmul(x[None], p["w_up"]).to(x.dtype)
    h = torch.nn.functional.silu(gate) * up
    out = torch.zeros((x.shape[0], cfg.d_model), dtype=torch.float32,
                      device=x.device)
    for e in range(cfg.n_experts):
        out += (h[e].float() @ p["w_down"][e].float()) * combine[:, e:e + 1]
    return out


# --- mini-batch: budget-capped payloads --------------------------------------

def _capped_payloads(device, n=512, B=16, budget=2048, seed=0,
                     empty=False):
    """The capped (bell, bell_t, spill) and (tc, tc_t, spill) triples on
    ``device`` (K = 8, C = 128) of edges whose first 256 rows keep within
    one block of the diagonal (at most 3 blocks a block row: padded slots
    past n_valid) and whose last 256 rows scatter (about 200 distinct
    columns a block row: both caps spill), or of no edge with ``empty``."""
    import numpy as np
    from repro_torch.core import formats as TF
    from repro_torch.kernels import registry as TR
    if empty:
        r = c = np.zeros(0, np.int32)
        v = np.zeros(0, np.float32)
    else:
        near = tp.random_edges(n, 3000, seed, block=B, spread=1)
        far = tp.random_edges(n, 8000, seed + 1)
        keep = (near[0] < n // 2, far[0] >= n // 2)
        r, c, v = (np.concatenate([a[keep[0]], b[keep[1]]])
                   for a, b in zip(near, far))
    coo = TF.coo_from_edges(n, n, r, c, v)
    stats = {"edge_budget": budget}
    return (TF.to_device(TR._bell_build(coo, None, B, stats), device),
            TF.to_device(tc_mod._tcgnn_build(coo, None, B, stats), device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("empty", [False, True])
def test_cuda_capped_payloads_match_plain(cuda_device, dtype, empty):  # noqa: F811
    """Every kernel over the budget-capped payloads (padded slots past
    n_valid pointing at block column 0; tcgnn C capped to 128) against its
    plain version, y_in off and on, at (Fi, Fo) in (500, 16), (16, 3),
    (3, 16); dW within 1e-5 of max|dW| (an empty tier's dW exactly 0)."""
    tol = (tp.F32_TOL if dtype == torch.float32
           else dict(atol=2e-1, rtol=3e-1))
    (bell, bell_t, bspill), (tc, tc_t, tspill) = _capped_payloads(
        cuda_device, empty=empty)
    assert bell.budgeted and tc.budgeted and tc.n_cond == 128
    assert bell.max_blocks == 8
    if not empty:
        assert bspill.nnz > 0 and tspill.nnz > 0
        assert int(bell.n_valid.min()) < bell.max_blocks
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def randn(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(dtype)

    def close(got, want):
        torch.testing.assert_close(got.float(), want.float(), **tol)

    def close_dw(got, want):
        scale = float(want.abs().max())
        if scale == 0.0:
            assert not bool(got.any())
        else:
            assert float((got - want).abs().max()) <= 1e-5 * scale

    n = bell.n_rows
    for Fi, Fo in ((500, 16), (16, 3), (3, 16)):
        x, g, w = randn(n, Fi), randn(n, Fo), randn(Fi, Fo) / Fi ** 0.5
        for y, yx in ((None, None), (randn(n, Fo), randn(n, Fi))):
            for p in (bell, bell_t):
                blk = p.blocks.to(dtype)
                close(bell_mod.bell_spmm(blk, p.col_idx, x, yx,
                                         n_valid=p.n_valid),
                      bell_mod.plain(blk, p.col_idx, x, yx))
                close(bellf_mod.bell_spmm_fused(blk, p.col_idx, x, w, y,
                                                n_valid=p.n_valid),
                      bellf_mod.plain(blk, p.col_idx, x, w, y))
            for p in (tc, tc_t):
                close(tc_mod.tcgnn_spmm(p.tiles, p.gather_idx, x, yx),
                      tc_mod.plain(p.tiles, p.gather_idx, x, yx))
                close(tc_mod.tcgnn_spmm_fused(p.tiles, p.gather_idx, x, w, y),
                      tc_mod.plain_fused(p.tiles, p.gather_idx, x, w, y))
        blk_t = bell_t.blocks.to(dtype)
        close_dw(bellf_mod.bell_spmm_dw(blk_t, bell_t.col_idx, x, g,
                                        n_valid=bell_t.n_valid),
                 bellf_mod.plain_dw(blk_t, bell_t.col_idx, x, g))
        close_dw(tc_mod.tcgnn_spmm_dw(tc_t.tiles, tc_t.gather_idx, x, g),
                 tc_mod.plain_dw(tc_t.tiles, tc_t.gather_idx, x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("acc", [False, True])
def test_cuda_capped_dispatch_matches_cpu(cuda_device, acc):  # noqa: F811
    """The registry's capped dispatch (kernels, with the spill's torch ops
    beside them) for bell, bell_fused, tcgnn_tile and tcgnn_tile_fused,
    plain (``acc``: accumulating) on the card against the CPU in float32,
    the payloads' dtype: values and the gradients of x, w and y_in."""
    from repro_torch.kernels.registry import REGISTRY
    tol, dtype = tp.F32_TOL, torch.float32
    card = dict(zip(("bell", "tcgnn_tile"), _capped_payloads(cuda_device)))
    cpu = dict(zip(("bell", "tcgnn_tile"), _capped_payloads(tp.CPU)))
    gen = torch.Generator().manual_seed(4)
    n = card["bell"][0].n_rows
    x0, w0 = torch.randn(n, 16, generator=gen), torch.randn(16, 3,
                                                            generator=gen)
    y0, cot = torch.randn(n, 3, generator=gen), torch.randn(n, 3,
                                                            generator=gen)
    for key in ("bell", "tcgnn_tile"):
        spec, fspec = REGISTRY.get(key), REGISTRY.get(key + "_fused")
        forms = ((lambda p, x, w, y: spec.matvec_acc(p, x @ w, y),
                  lambda p, x, w, y: fspec.fused_matvec_acc(p, x, w, y))
                 if acc else
                 (lambda p, x, w, y: spec.matvec(p, x @ w),
                  lambda p, x, w, y: fspec.fused_matvec(p, x, w)))
        for fn in forms:
            outs = []
            for p, dev in ((card[key], cuda_device), (cpu[key], tp.CPU)):
                leaves = [t.detach().to(dev, dtype).requires_grad_()
                          for t in (x0, w0, y0)]
                y = fn(p, *leaves)
                (y.float() * cot.to(dev)).sum().backward()
                outs.append([y.detach().cpu()] + [
                    (t.grad if t.grad is not None
                     else torch.zeros_like(t)).cpu() for t in leaves])
            for a, b in zip(*outs):
                torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag_fused", "tcgnn_tile_fused")])
@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_cuda_minibatch_training_matches_cpu(cuda_device, plan, model):  # noqa: F811
    """Mini-batch training with a fixed plan on the card against the CPU
    from one parameter set: the same batch stream (plans, hits), cache
    counters and trace count, losses within atol 5e-3, rtol 1e-2."""
    import numpy as np
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as TG
    g = TG.synth_dataset("cora", 0.2, seed=0, comm_size=16)
    cfg = gnn.GNNConfig(model=model, hidden=16, comm_size=16,
                        sampler="cluster", clusters_per_batch=8,
                        inter_buckets=2, selector="fixed",
                        fixed_kernels=plan)
    params = gnn.init_model(torch.Generator().manual_seed(0), cfg,
                            g.features.shape[1], g.n_classes, "cpu")
    card = gnn.train(g, cfg, steps=6, device=cuda_device, params=params)
    cpu = gnn.train(g, cfg, steps=6, device="cpu", params=params)
    assert card.plan_history == cpu.plan_history
    assert card.hit_history == cpu.hit_history and card.cache == cpu.cache
    assert card.n_traces == len(card.plans) == 1
    np.testing.assert_allclose(card.losses, cpu.losses, atol=5e-3,
                               rtol=1e-2)


def _mb_async_pair(cuda_device, steps=8, **changes):  # noqa: F811
    """One mini-batch run on the card synchronously and one through the
    pipeline (prefetch 3, 2 workers), both under deterministic
    algorithms (CUDA index_add_ is not deterministic otherwise)."""
    import dataclasses
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as TG
    g = TG.synth_dataset("cora", 0.2, seed=0, comm_size=16)
    cfg = gnn.GNNConfig(hidden=16, comm_size=16, sampler="cluster",
                        clusters_per_batch=8, inter_buckets=2, **changes)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sync = gnn.train(g, cfg, steps=steps, device=cuda_device)
        asyn = gnn.train(g, dataclasses.replace(cfg, prefetch_depth=3,
                                                pipeline_workers=2),
                         steps=steps, device=cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)
    return sync, asyn


@pytest.mark.cuda
@pytest.mark.parametrize("changes", [
    dict(), dict(model="sage", selector="fixed",
                 fixed_kernels=("block_diag_fused", "tcgnn_tile_fused"))],
    ids=["gcn_feedback", "sage_fixed"])
def test_cuda_async_minibatch_matches_sync(cuda_device, changes):  # noqa: F811
    """Batches staged by the pipeline's workers on streams of their own
    give the synchronous run's losses bit for bit, and its plans, hits,
    cache counters and trace count."""
    sync, asyn = _mb_async_pair(cuda_device, **changes)
    assert asyn.losses == sync.losses
    assert asyn.plan_history == sync.plan_history
    assert asyn.hit_history == sync.hit_history and asyn.cache == sync.cache
    assert asyn.n_traces == sync.n_traces == len(sync.plans)
    assert asyn.pipeline["delivered"] == 8 and sync.pipeline is None


@pytest.mark.cuda
def test_cuda_retried_async_minibatch_matches_sync(cuda_device):  # noqa: F811
    """Transient worker faults absorbed by the pipeline's retries on the
    card: under deterministic algorithms the retried async run gives the
    fault-free sync run's losses bit for bit, and its plans, hits, cache
    counters and trace count; three retries counted."""
    import dataclasses
    from repro_torch.core import gnn
    from repro_torch.distributed import FaultPlan
    from repro_torch.graphs import graph as TG
    from repro_torch.train import gnn_steps
    g = TG.synth_dataset("cora", 0.2, seed=0, comm_size=16)
    cfg = gnn.GNNConfig(hidden=16, comm_size=16, sampler="cluster",
                        clusters_per_batch=8, inter_buckets=2)
    fp = FaultPlan(worker_faults={2: 2, 5: 1})
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sync = gnn.train(g, cfg, steps=8, device=cuda_device)
        asyn = gnn_steps.train_minibatch(
            g, dataclasses.replace(cfg, prefetch_depth=3, pipeline_workers=2,
                                   retry_max=3, retry_base_delay_s=0.001),
            steps=8, device=cuda_device, fault_plan=fp)
    finally:
        torch.use_deterministic_algorithms(False)
    assert asyn.losses == sync.losses
    assert asyn.plan_history == sync.plan_history
    assert asyn.hit_history == sync.hit_history and asyn.cache == sync.cache
    assert asyn.n_traces == sync.n_traces == len(sync.plans)
    assert asyn.faults["retries"] == asyn.pipeline["retries"] == 3
    assert fp.injected_worker == 3


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [0, 3], ids=["sync", "async"])
def test_cuda_failing_launch_is_not_retried(cuda_device, monkeypatch,
                                            prefetch):  # noqa: F811
    """A kernel launch that fails (its library's launch raising, as a CUDA
    error does) ends the run with that error through a retry budget of 3:
    no retry, no second launch, no other plan."""
    import dataclasses
    import threading
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as TG
    from repro_torch.kernels import _build
    from repro_torch.obs import Telemetry
    from repro_torch.train import gnn_steps
    g = TG.synth_dataset("cora", 0.2, seed=0, comm_size=16)
    cfg = gnn.GNNConfig(hidden=16, comm_size=16, sampler="cluster",
                        clusters_per_batch=8, inter_buckets=2,
                        selector="fixed", fixed_kernels=("block_diag", "bell"),
                        retry_max=3, retry_base_delay_s=10.0)
    cfg = dataclasses.replace(cfg, prefetch_depth=prefetch,
                              pipeline_workers=2)
    real = _build.Built.launch
    calls = []
    err = RuntimeError("block_diag_spmm launch failed: injected")

    def launch(self, *args):
        if self.name == "block_diag_spmm":
            calls.append(1)
            raise err
        return real(self, *args)

    monkeypatch.setattr(_build.Built, "launch", launch)
    tele = Telemetry()
    with pytest.raises(RuntimeError) as info:
        gnn_steps.train_minibatch(g, cfg, steps=6, device=cuda_device,
                                  telemetry=tele)
    assert info.value is err and len(calls) == 1
    assert tele.metrics.counter("faults.retries").value == 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("pipeline-")]


@pytest.mark.cuda
def test_cuda_pipeline_staged_tensors_are_recorded_on_the_consumer_stream(
        cuda_device, monkeypatch):  # noqa: F811
    """The staging copy runs on the worker's own stream, from pinned host
    memory; the consumer orders its stream after the copy's event and
    records its stream on every staged tensor before the step reads it."""
    import threading
    import numpy as np
    from repro_torch.train import gnn_steps
    stager = gnn_steps._Stager(cuda_device)
    host = [np.arange(12, dtype=np.float32), np.ones(5, dtype=bool)]
    out = {}

    def worker():
        out["staged"] = stager.stage(lambda copy: [copy(a) for a in host])
        out["worker_stream"] = stager._local.stream

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    args, ready, staged = out["staged"]
    assert out["worker_stream"] != torch.cuda.default_stream(cuda_device)
    assert [a.data_ptr() for a in args] == [a.data_ptr() for a in staged]
    recorded = []
    real = torch.Tensor.record_stream

    def spy(self, stream):
        recorded.append((self.data_ptr(), stream))
        return real(self, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", spy)
    gnn_steps._Stager.hand_over(ready, staged)
    consumer = torch.cuda.current_stream(cuda_device)
    assert recorded == [(a.data_ptr(), consumer) for a in staged]
    for a, h in zip(args, host):
        assert np.array_equal(a.cpu().numpy(), h)
    # a whole run: every staged tensor of every batch is recorded
    recorded.clear()
    _, asyn = _mb_async_pair(cuda_device, steps=4)
    assert len(recorded) >= 4 * 5
    assert all(s == consumer for _, s in recorded)


# -- the GNN inference server on the card -------------------------------------

def _serve_pair(device, plan, **scfg):
    """A GCN trained 4 steps on the card with a fixed plan, served on the
    card and on the CPU from the same params through PlanCaches that
    commit that plan (cora at scale 0.2, neighbor fanouts (4, 2), three
    rungs)."""
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as TG
    from repro_torch.serve import EgoNetSampler, InferenceServer, ServeConfig
    from repro_torch.serve.server import plan_cache_for
    from repro_torch.train import gnn_steps
    g = TG.synth_dataset("cora", 0.2, seed=0, comm_size=16)
    cfg = gnn.GNNConfig(hidden=16, comm_size=16, sampler="neighbor",
                        batch_nodes=32, fanouts=(4, 2), selector="fixed",
                        fixed_kernels=plan)
    res = gnn_steps.train_minibatch(g, cfg, steps=4, eval_batches=0,
                                    device=device)
    kw = dict(deadline_s=30.0, queue_limit=64, max_batch=8, max_wait_s=0.0)
    kw.update(scfg)
    budget = EgoNetSampler(g, cfg, (cfg.fanouts,)).pad_budget(0)
    return g, [InferenceServer(g, cfg, res.params,
                               serve_cfg=ServeConfig(**kw), device=d,
                               plan_cache=plan_cache_for(
                                   g, cfg, budget, fixed_kernels=plan,
                                   device=d))
               for d in (device, "cpu")]


# forward launches per batch of a fixed plan, per kernel wrapper (2 layers,
# one diagonal and one inter tier: each kernel of the plan once a layer)
_SERVE_COUNTS = {"block_diag": bd_mod.launches, "bell": bell_mod.launches,
                 "block_diag_fused": bdf_mod.launches,
                 "tcgnn_tile_fused": tc_mod.fused_launches}


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag_fused", "tcgnn_tile_fused")])
def test_cuda_server_makes_no_record_after_warmup_and_launches_its_plan(
        cuda_device, plan):  # noqa: F811
    """After warmup, 32 requests in step() mode on the card make no new
    shape record, launch each kernel of the committed plan twice a batch
    (and nothing else), and give the CPU server's preds and logits
    (float32 atol = rtol = 1e-4)."""
    import numpy as np
    g, (card, cpu) = _serve_pair(cuda_device, plan)
    for srv in (card, cpu):
        srv.warmup()
    traces = card.n_traces
    assert traces == cpu.n_traces == 3        # one plan x three rungs
    nodes = [(i * 53 + 1) % g.n for i in range(32)]
    before = {k: c.value for k, c in _SERVE_COUNTS.items()}
    out = []
    for srv in (card, cpu):
        futs = [srv.submit(v) for v in nodes]
        for _ in range(100):
            if all(f.done() for f in futs):
                break
            srv.step()
        out.append([f.result(0) for f in futs])
    used = {k: c.value - before[k] for k, c in _SERVE_COUNTS.items()}
    batches = card.stats()["batches"]
    assert batches == 4 and card.plan_batches == {(plan, plan): 4}
    assert used == {k: (2 * batches if k in plan else 0)
                    for k in _SERVE_COUNTS}
    assert card.n_traces == traces
    for (sa, va), (sb, vb) in zip(*out):
        assert sa == sb == "ok" and va["pred"] == vb["pred"]
        np.testing.assert_allclose(va["logits"], vb["logits"], **tp.F32_TOL)


@pytest.mark.cuda
def test_cuda_server_failing_launch_fails_its_requests(cuda_device,
                                                       monkeypatch):  # noqa: F811
    """A launch that fails on the card finishes the batch's requests ERROR
    with that error: no quarantine, no recovery, no CPU or other plan,
    and warmup raises on it."""
    from repro_torch.kernels import _build
    _, (card, _) = _serve_pair(cuda_device, ("block_diag", "bell"))
    card.warmup()
    real = _build.Built.launch
    err = RuntimeError("bell_spmm launch failed: injected")

    def launch(self, *args):
        if self.name == "bell_spmm":
            raise err
        return real(self, *args)

    monkeypatch.setattr(_build.Built, "launch", launch)
    futs = [card.submit(v) for v in range(8)]
    for _ in range(20):
        if all(f.done() for f in futs):
            break
        card.step()
    assert [f.result(0) for f in futs] == [("error", err)] * 8
    st = card.stats()
    assert st["errors"] == 8 and st["batches"] == 0
    assert st["quarantined"] == st["recoveries"] == 0
    assert card.plan_batches == {}
    with pytest.raises(RuntimeError) as info:
        card.warmup()
    assert info.value is err


@pytest.mark.cuda
@pytest.mark.parametrize("dt_scale", [0.1, 2.0])
def test_cuda_mamba_scan_trainable_gradients(cuda_device, dt_scale):  # noqa: F811
    """mamba_scan_trainable on the card: one kernel launch in the forward,
    none in the backward (it recomputes through the plain oracle); its
    output and the gradients of all six inputs against autograd through
    the plain version on the card (float32, the reference's 1e-4)."""
    gen = torch.Generator(device=cuda_device).manual_seed(39)
    args = _mamba_inputs(gen, 2, 256, 512, 16, cuda_device, dt_scale)
    cot = torch.randn((2, 256, 512), generator=gen, device=cuda_device)
    out = []
    for fn in (ms_mod.mamba_scan_trainable,
               lambda x, dt, Bc, Cc, A, D: ms_mod.plain(x, dt, A, Bc, Cc,
                                                        D)):
        leaves = [a.clone().requires_grad_() for a in args]
        before = ms_mod.launches.value
        y = fn(*leaves)
        fwd = ms_mod.launches.value - before
        grads = torch.autograd.grad((y * cot).sum(), leaves)
        torch.cuda.synchronize()
        out.append((y.detach(), grads, fwd, ms_mod.launches.value - before))
    (y, g, fwd, total), (want_y, want_g, _, plain_launches) = out
    assert (fwd, total, plain_launches) == (1, 1, 0)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    for name, a, b in zip(("x", "dt", "Bc", "Cc", "A", "D"), g, want_g):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)


def _np_params(cfg, seed: int = 0):
    """A parameter tree as numpy (the reference's form, as
    lm_from_jax_params takes it), drawn by the port on the CPU."""
    import numpy as np
    from repro_torch.models import lm
    p = lm.init_params(lm.make_generator(seed, "cpu"), cfg)
    return lm._tree_map(lambda a: np.asarray(a.float().numpy()), p)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,changes,per_step", [
    ("internlm2_1_8b", dict(attn_core="flash"), dict(flash_attention=6)),
    ("jamba_v0_1_52b", dict(mamba_core="pallas", attn_core="flash"),
     dict(flash_attention=2, mamba_scan=14)),
    ("rwkv6_7b", dict(wkv_core="xla"), {})])
def test_cuda_lm_train_step_matches_cpu(cuda_device, arch, changes,  # noqa: F811
                                        per_step):
    """make_train_step at each family's REDUCED config in float32, 2 steps
    (lr 1e-3, warmup 1) on the card and on the CPU in lockstep (the first
    from one numpy parameter tree, the second from the CPU's state on
    both: RWKV-6's chunked form and Jamba's router make two free runs
    drift apart), batch 2 x 128: metrics and gradients (the first moments)
    at float32 1e-4 / 1e-5, params within tp.AdamSlack; the kernels'
    launches per step under remat "dots" (each layer's forward again in
    the backward: 2 flash per InternLM2 layer, 14 mamba_scan and 2 flash
    per Jamba period), none in RWKV-6's "xla" core."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import lm_from_jax_params
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              **changes)
    host = _np_params(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 129)).astype(
        np.int32)
    batch = {k: torch.from_numpy(v) for k, v in
             dict(tokens=toks[:, :-1], labels=toks[:, 1:]).items()}
    counts = {"flash_attention": fa_mod.launches, "mamba_scan":
              ms_mod.launches, "rwkv6_chunked": rk_mod.launches}
    step = steps.make_train_step(cfg, adamw.OptConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))

    def leaves(tree):
        return [a.detach().cpu().numpy() for a in tree_leaves(tree)]

    p_cpu = lm_from_jax_params(host, cfg, device="cpu")
    p_card = lm_from_jax_params(host, cfg, device=cuda_device)
    o_cpu, o_card = adamw.init_state(p_cpu), adamw.init_state(p_card)
    for t in (1, 2):
        if t > 1:
            p_card, o_card = (tree_map(lambda a: a.to(cuda_device), x)
                              for x in (p_cpu, o_cpu))
        before = {k: c.value for k, c in counts.items()}
        p_card, o_card, m_card = step(p_card, o_card, {
            k: v.to(cuda_device) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert {k: c.value - before[k] for k, c in counts.items()
                if c.value - before[k]} == per_step
        before = {k: c.value for k, c in counts.items()}
        p_cpu, o_cpu, m_cpu = step(p_cpu, o_cpu, batch)
        assert {k: c.value for k, c in counts.items()} == before
        for k in m_cpu:
            a, b = float(m_cpu[k]), float(m_card[k])
            assert abs(a - b) <= 1e-5 + 1e-4 * abs(a), (t, k, a, b)
        # the gradients' part of m (0.1 g) at 1e-5 / 1e-4
        for x, y in zip(leaves(o_cpu["m"]), leaves(o_card["m"])):
            np.testing.assert_allclose(y, x, atol=1e-6, rtol=1e-4)
        slack = tp.AdamSlack()
        slack.t = t - 1
        slack.step(leaves(o_cpu["m"]), leaves(o_cpu["v"]),
                   leaves(o_card["m"]), leaves(o_card["v"]),
                   float(m_cpu["lr"]))
        slack.check(leaves(p_cpu), leaves(p_card),
                    [str(i) for i in range(len(leaves(p_cpu)))],
                    f"{arch} step {t} card vs CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mla_flash_core_matches_plain(cuda_device, dtype):  # noqa: F811
    """MLA at DeepSeek-V3 REDUCED's ranks (4 heads, q/k 16 + 8, v 16) and
    at a wider head (q/k 128 + 64, v 128, MLA's published head dims, 8
    heads), 256 tokens: the flash core launches the flash kernel once on
    q = [q_nope; q_rope] and k = [k_nope; k_rope on every head], and the
    attention output it feeds matches the same attention by the kernel's
    plain version on the same operands (the reference's flash tolerances;
    bf16 also per row); the layer's output matches the softmax core's
    (float32 1e-4 / the reference's bf16 2e-1 / 3e-1)."""
    import dataclasses
    from repro_torch.models import blocks as blk
    for kw in (dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
               dict(d_model=256, n_heads=8, q_lora_rank=64, kv_lora_rank=32,
                    qk_nope_dim=128, qk_rope_dim=64, v_dim=128)):
        cfg = blk.MLAConfig(**kw, attn_core="flash")
        gen = torch.Generator(device=cuda_device).manual_seed(50)
        p = {k: v.to(dtype) for k, v in blk.init_mla(gen, cfg).items()}
        x = torch.randn((2, 256, cfg.d_model), generator=gen,
                        device=cuda_device).to(dtype)
        pos = torch.arange(256, device=cuda_device)[None].expand(2, 256)
        seen = []
        orig = fa_mod.flash_attention

        def spy(q, k, v, **kw):
            out = orig(q, k, v, **kw)
            seen.append((q, k, v, kw, out))
            return out

        fa_mod.flash_attention = spy
        try:
            before = fa_mod.launches.value
            got = blk.mla_apply(p, cfg, x, pos)
            torch.cuda.synchronize()
            assert fa_mod.launches.value - before == 1
        finally:
            fa_mod.flash_attention = orig
        (q, k, v, kw, out), = seen
        assert q.shape == (2, cfg.n_heads, 256, cfg.qk_dim)
        assert v.shape == (2, cfg.n_heads, 256, cfg.v_dim)
        assert kw["scale"] == cfg.qk_dim ** -0.5
        assert_flash_close(out, fa_mod.plain(q, k, v, causal=True,
                                             scale=kw["scale"]))
        want = blk.mla_apply(p, dataclasses.replace(cfg, attn_core="softmax"),
                             x, pos)
        tol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
               else dict(atol=2e-1, rtol=3e-1))
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_step", [("deepseek_moe_16b", 3),
                                           ("deepseek_v3_671b", 5)])
def test_cuda_deepseek_reduced_matches_cpu(cuda_device, arch,  # noqa: F811
                                           per_step):
    """DeepSeekMoE and DeepSeek-V3 REDUCED in float32 under the serving
    profile (flash core), batch 2 x 128: the prefill step launches the
    flash kernel once a layer (V3: and once in the MTP block), the cache
    prefill only at MLA layers, decode never; the prefill step's logits,
    the cache prefill's and three decode steps' match the same on the CPU
    (1e-3, the reference's prefill/decode tolerance)."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch.serve_lm import serving_profile
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = configs.get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, **serving_profile(cfg))
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    card_params = lm._tree_map(lambda a: a.to(cuda_device), params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 131)).astype(np.int32))
    P = 128
    out = {}
    for dev, p in (("cuda", card_params), ("cpu", params)):
        t = toks.to(dev)
        before = fa_mod.launches.value
        step = steps.make_prefill_step(cfg)(p, dict(tokens=t[:, :P]))
        torch.cuda.synchronize()
        mid = fa_mod.launches.value
        lg, caches = lm.prefill(p, cfg, dict(tokens=t[:, :P]), s_max=131)
        torch.cuda.synchronize()
        pre = fa_mod.launches.value
        dec = [lm.decode_step(p, cfg, caches, t[:, i:i + 1], i)[0]
               for i in range(P, 131)]
        torch.cuda.synchronize()
        out[dev] = (step, lg, torch.cat(dec, 1))
        launches = (mid - before, pre - mid, fa_mod.launches.value - pre)
        mla_layers = cfg.n_layers if cfg.attn_type == "mla" else 0
        assert launches == ((per_step, mla_layers, 0) if dev == "cuda"
                            else (0, 0, 0)), (dev, launches)
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 28, 4, 1024, 128),
                                   (8, 20, 20, 384, 64)])
def test_cuda_flash_attention_at_qwen2_vl_and_whisper_shapes(
        cuda_device, dtype, shape):  # noqa: F811
    """flash_attention, causal, at Qwen2-VL-7B's prefill (B 4, Hq 28, Hkv
    4: a GQA group of 7, S 1024, d 128) and Whisper-large-v3's decoder
    self-attention (B 8, 20 heads, S 384, d 64) against its plain version
    (the reference's flash tolerances; bf16 also per row): the bfloat16
    tensor-core path and the float32 CUDA-core path."""
    B, Hq, Hkv, S, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(Hq + S)
    q, k, v = (torch.randn((B, h, S, d), generator=gen,
                           device=cuda_device).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before = fa_mod.launches.value
    got = fa_mod.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_mod.launches.value - before == 1
    assert got.dtype == dtype and got.shape == (B, Hq, S, d)
    assert_flash_close(got, fa_mod.plain(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_step", [("qwen2_vl_7b", 3),
                                           ("whisper_large_v3", 2)])
def test_cuda_qwen2_vl_and_whisper_reduced_match_cpu(  # noqa: F811
        cuda_device, arch, per_step):
    """Qwen2-VL and Whisper REDUCED in float32 under the serving profile
    (flash core), batch 2 x 128 (Qwen2-VL's three M-RoPE streams distinct,
    Whisper over 32 encoder frames): the prefill step launches the flash
    kernel once a layer (Whisper: its decoder layers only) and its logits
    match the CPU's; Qwen2-VL's cache prefill and three decode steps, and
    Whisper's three decode steps from init_cache, launch nothing and match
    the CPU's (1e-3, the reference's prefill/decode tolerance)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.pipeline import stub_batch
    from repro_torch.launch.serve_lm import serving_profile
    from repro_torch.models import lm
    from repro_torch.train import steps
    cfg = configs.get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, **serving_profile(cfg))
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    card_params = lm._tree_map(lambda a: a.to(cuda_device), params)
    batch = stub_batch(cfg, 2, 131, 4, image=dict(text=16, rows=8, cols=12,
                                                  after=19))
    P = 128
    out = {}
    for dev, p in (("cuda", card_params), ("cpu", params)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        head = {k: (v[:, :, :P] if k == "positions"
                    else v if k == "enc_embeds" else v[:, :P])
                for k, v in b.items()}
        before = fa_mod.launches.value
        step = steps.make_prefill_step(cfg)(p, head)
        torch.cuda.synchronize()
        mid = fa_mod.launches.value
        if cfg.family == "encdec":
            caches, start, feed = lm.init_cache(cfg, 2, 8, device=dev), 0, \
                b["tokens"]
            lg = step
        else:
            lg, caches = lm.prefill(p, cfg, head, s_max=131)
            start, feed = P, b["embeds"]
        dec = [lm.decode_step(p, cfg, caches, feed[:, i:i + 1], i)[0]
               for i in range(start, start + 3)]
        torch.cuda.synchronize()
        out[dev] = (step, lg, torch.cat(dec, 1))
        launches = (mid - before, fa_mod.launches.value - mid)
        assert launches == ((per_step, 0) if dev == "cuda" else (0, 0)), \
            (dev, launches)
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_cuda_mesh_places_leaves_on_the_card(cuda_device):
    """A 1 x 1 mesh over cuda:0 (make_mesh and host_local_mesh) places
    InternLM2 REDUCED's params through their resolved shardings on the
    card, values unchanged; a mesh of more devices than the card count
    raises, and so does placing onto the abstract production mesh."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    cfg = configs.get_config("internlm2_1_8b", reduced=True)
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    for mesh in (mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda"),
                 mesh_mod.host_local_mesh("cuda:0")):
        assert mesh.devices[0].type == "cuda"
        shard = sharding.tree_shardings(params, lm.param_specs(cfg), mesh)
        placed = sharding.place_tree(params, shard)
        for a, b in zip(tree_leaves(params), tree_leaves(placed)):
            assert b.device.type == "cuda" and b.device.index == 0
            assert torch.equal(a, b.cpu())
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {n + 1} devices"):
        mesh_mod.make_mesh((n + 1, 1), ("data", "model"), "cuda")
    with pytest.raises(ValueError, match="abstract"):
        sharding.NamedSharding(mesh_mod.make_production_mesh(),
                               sharding.P()).place(
            torch.zeros(2, device=cuda_device))
