"""Blocked-ELL SpMM: Y[i] = sum_k blocks[i,k] @ X[col_idx[i,k]] (+ Y_in).

Replaces the Pallas TPU kernel ``repro/kernels/bell_spmm.py``
(``bell_spmm``).  On CUDA tensors the wrapper launches the hand kernel in
``csrc/bell_spmm.cu`` (design and bound in its header); on CPU tensors it
runs the plain version ``ref.bell_spmm``.  There is no fallback between
the two: a CUDA input launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.block_diag_spmm import DTYPE_CODES, MAX_BLOCK

plain = ref.bell_spmm
launches = _build.LaunchCount()


def _check(blocks, col_idx, x, y_in, n_valid) -> None:
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be (nbr, K, B, B), "
                         f"got {tuple(blocks.shape)}")
    nbr, K, B, _ = blocks.shape
    if tuple(col_idx.shape) != (nbr, K):
        raise ValueError(f"col_idx must be {(nbr, K)}, "
                         f"got {tuple(col_idx.shape)}")
    if x.dim() != 2 or x.shape[0] % B:
        raise ValueError(f"x must be (n_cols, F) with n_cols a multiple of "
                         f"{B}, got {tuple(x.shape)}")
    if y_in is not None and tuple(y_in.shape) != (nbr * B, x.shape[1]):
        raise ValueError(f"y_in must be {(nbr * B, x.shape[1])}, "
                         f"got {tuple(y_in.shape)}")
    if n_valid is not None and tuple(n_valid.shape) != (nbr,):
        raise ValueError(f"n_valid must be {(nbr,)}, "
                         f"got {tuple(n_valid.shape)}")
    tensors = [t for t in (blocks, col_idx, x, y_in, n_valid) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("bell_spmm operands must lie on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != x.dtype for t in (blocks, y_in) if t is not None):
        raise ValueError(f"blocks, x and y_in must share one dtype, got "
                         f"{blocks.dtype}, {x.dtype}"
                         + (f", {y_in.dtype}" if y_in is not None else ""))


def bell_spmm(blocks: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
              y_in: torch.Tensor | None = None,
              n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A_bell @ x (+ y_in), float32 accumulation.  Returns (nbr*B, F).

    blocks: (nbr, K, B, B); col_idx: (nbr, K) int32 block columns of x;
    x: (n_cols, F); y_in: optional (nbr*B, F).  ``n_valid`` (nbr,) int32,
    when given, is the number of real (leading) slots per block row: the
    kernel stops there, since padding slots are all-zero blocks.  CUDA
    tensors must be contiguous float32 or bfloat16 with B <= 64."""
    _check(blocks, col_idx, x, y_in, n_valid)
    if x.device.type == "cpu":
        return plain(blocks, col_idx, x, y_in)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"CUDA kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if col_idx.dtype != torch.int32 or (n_valid is not None
                                        and n_valid.dtype != torch.int32):
        raise ValueError("col_idx and n_valid must be int32")
    tensors = [t for t in (blocks, col_idx, x, y_in, n_valid) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("CUDA kernel takes contiguous tensors")
    nbr, K, B, _ = blocks.shape
    if not 1 <= B <= MAX_BLOCK:
        raise ValueError(f"CUDA kernel takes block sizes 1..{MAX_BLOCK}, "
                         f"got {B}")
    y = torch.empty((nbr * B, x.shape[1]), dtype=x.dtype, device=x.device)
    lib = _build.library("bell_spmm")
    with torch.cuda.device(x.device):
        lib.launch(blocks.data_ptr(), col_idx.data_ptr(),
                   n_valid.data_ptr() if n_valid is not None else None,
                   x.data_ptr(),
                   y_in.data_ptr() if y_in is not None else None,
                   y.data_ptr(), nbr, K, B, x.shape[1],
                   DTYPE_CODES[x.dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    launches.add()
    return y
