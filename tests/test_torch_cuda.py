"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a CUDA GPU and nvcc and skip elsewhere; this file
imports neither jax nor repro, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's (tests/test_fused.py): float32
atol = rtol = 1e-4, bfloat16 atol = 2e-1, rtol = 3e-1."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import pytest
import torch

from repro_torch.kernels import bell_spmm as bell_mod
from repro_torch.kernels import block_diag_spmm as bd_mod
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
