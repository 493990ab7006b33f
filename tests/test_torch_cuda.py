"""The port's CUDA kernels against their plain PyTorch versions, and the
training path's gradients against the CPU's, on the card.  These tests
need a CUDA GPU and nvcc and skip elsewhere; this file
imports neither jax nor repro, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's (tests/test_fused.py): float32
atol = rtol = 1e-4, bfloat16 atol = 2e-1, rtol = 3e-1.  dW, float32 on
both sides for either input dtype, is held to 1e-5 of its largest entry
(from unit-scale cotangents): only the order of float32 sums differs."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import pytest
import torch

from repro_torch.kernels import bell_spmm as bell_mod
from repro_torch.kernels import bell_spmm_fused as bellf_mod
from repro_torch.kernels import block_diag_spmm as bd_mod
from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
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
    two runs give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    blocks, col_idx, n_valid = _synthetic_bell(gen, 16, cuda_device,
                                               nbr=300, K=6)
    x = torch.randn((300 * 16, 500), generator=gen, device=cuda_device)
    g = torch.randn((300 * 16, 16), generator=gen, device=cuda_device)
    a = bellf_mod.bell_spmm_dw(blocks, col_idx, x, g, n_valid=n_valid)
    b = bellf_mod.bell_spmm_dw(blocks, col_idx, x, g, n_valid=n_valid)
    assert torch.equal(a, b)
    _close_dw(a, bellf_mod.plain_dw(blocks, col_idx, x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [("block_diag", "bell"),
                                  ("block_diag_fused", "bell_fused")])
def test_cuda_gradients_match_cpu(cuda_device, plan):  # noqa: F811
    """One loss.backward through the kernels' backward passes on the card
    against the same on the CPU (plain versions), from the same
    parameters."""
    from repro_torch.core import adaptgear, gnn
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.synth_dataset("pubmed", 0.03, seed=0, comm_size=8,
                                max_feat=32)
    cfg = gnn.GNNConfig(hidden=8, n_layers=2, comm_size=8,
                        fixed_kernels=plan)
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
