"""Forward aggregation entry points over format payloads.

Counterpart of ``repro/kernels/ops.py`` (forward only; backward comes with
training).  ``block_diag_*`` and ``bell_*`` reach the hand CUDA kernels on
CUDA tensors and their plain versions on CPU tensors; ``ell``/``coo`` are
plain PyTorch gather and ``index_add_`` on any device.  The TPU's 128-lane
feature padding and feature tiling are not carried over: the CUDA kernels
take any width.
"""
from __future__ import annotations

import torch

from repro_torch.core import formats
from repro_torch.kernels import ref
from repro_torch.kernels.bell_spmm import bell_spmm
from repro_torch.kernels.block_diag_spmm import block_diag_spmm


def block_diag_matvec(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ x."""
    return block_diag_spmm(blocks, x)


def block_diag_matvec_acc(blocks: torch.Tensor, x: torch.Tensor,
                          y_in: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ x + y_in (accumulating dispatch mode)."""
    return block_diag_spmm(blocks, x, y_in)


def _bell_fwd(bell: formats.BlockELL, x: torch.Tensor,
              y_in: torch.Tensor | None = None) -> torch.Tensor:
    return bell_spmm(bell.blocks, bell.col_idx, x, y_in,
                     n_valid=bell.n_valid)


def bell_matvec(bell: formats.BlockELL, bell_t: formats.BlockELL,
                x: torch.Tensor) -> torch.Tensor:
    """Y = A_bell @ x.  ``bell_t`` is the transpose payload the backward
    pass will run over; the forward does not read it."""
    return _bell_fwd(bell, x)


def bell_matvec_acc(bell: formats.BlockELL, bell_t: formats.BlockELL,
                    x: torch.Tensor, y_in: torch.Tensor) -> torch.Tensor:
    """Y = A_bell @ x + y_in (accumulating dispatch mode)."""
    return _bell_fwd(bell, x, y_in)


def ell_matvec(ell: formats.ELL, x: torch.Tensor) -> torch.Tensor:
    """Padded-neighbor gather (vertex-parallel CSR analogue)."""
    return ref.ell_spmm(ell.indices, ell.vals, x)


def coo_matvec(coo: formats.COO, x: torch.Tensor) -> torch.Tensor:
    """Edge-parallel scatter-add through ``index_add_``."""
    return ref.coo_spmm(coo.rows, coo.cols, coo.vals, x, coo.n_rows)
