"""Block-diagonal SpMM: Y = blockdiag(A_1..A_nb) @ X (+ Y_in), or with
``transpose`` Y = blockdiag(A_1^T..A_nb^T) @ X (+ Y_in) (the backward pass).

Replaces the Pallas TPU kernel ``repro/kernels/block_diag_spmm.py``
(``block_diag_spmm``).  On CUDA tensors the wrapper launches the hand
kernel in ``csrc/block_diag_spmm.cu`` (design and bound in its header);
on CPU tensors it runs the plain version ``ref.block_diag_spmm``.  There
is no fallback between the two: a CUDA input launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.block_diag_spmm
launches = _build.LaunchCount()


def _check(blocks: torch.Tensor, x: torch.Tensor,
           y_in: torch.Tensor | None) -> None:
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be (nb, B, B), got {tuple(blocks.shape)}")
    nb, B, _ = blocks.shape
    if x.dim() != 2 or x.shape[0] != nb * B:
        raise ValueError(f"x must be ({nb * B}, F) for blocks "
                         f"{tuple(blocks.shape)}, got {tuple(x.shape)}")
    if y_in is not None and y_in.shape != x.shape:
        raise ValueError(f"y_in must be {tuple(x.shape)}, "
                         f"got {tuple(y_in.shape)}")
    _build.check_operands((x, blocks, y_in))


def block_diag_spmm(blocks: torch.Tensor, x: torch.Tensor,
                    y_in: torch.Tensor | None = None, *,
                    transpose: bool = False) -> torch.Tensor:
    """Y = blockdiag(blocks) @ x (+ y_in), float32 accumulation; with
    ``transpose`` each block is read transposed (no copy is made).

    blocks: (nb, B, B); x: (nb*B, F); y_in: optional (nb*B, F).  CUDA
    tensors must be contiguous float32 or bfloat16 with B <= 64."""
    _check(blocks, x, y_in)
    if x.device.type == "cpu":
        return plain(blocks, x, y_in, transpose=transpose)
    nb, B, _ = blocks.shape
    code = _build.cuda_dtype_code((x, blocks, y_in), block_size=B)
    y = torch.empty_like(x)
    lib = _build.library("block_diag_spmm")
    with torch.cuda.device(x.device):
        lib.launch(blocks.data_ptr(), x.data_ptr(), _build.ptr(y_in),
                   y.data_ptr(), nb, B, x.shape[1], int(transpose), code,
                   _build.stream(x))
    launches.add()
    return y
