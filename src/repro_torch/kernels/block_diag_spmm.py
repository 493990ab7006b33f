"""Block-diagonal SpMM: Y = blockdiag(A_1..A_nb) @ X (+ Y_in).

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

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCK = 64


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
    tensors = [blocks, x] + ([y_in] if y_in is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("blocks, x and y_in must lie on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError("blocks, x and y_in must share one dtype, got "
                         f"{[t.dtype for t in tensors]}")


def block_diag_spmm(blocks: torch.Tensor, x: torch.Tensor,
                    y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y = blockdiag(blocks) @ x (+ y_in), float32 accumulation.

    blocks: (nb, B, B); x: (nb*B, F); y_in: optional (nb*B, F).  CUDA
    tensors must be contiguous float32 or bfloat16 with B <= 64."""
    _check(blocks, x, y_in)
    if x.device.type == "cpu":
        return plain(blocks, x, y_in)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"CUDA kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    tensors = [blocks, x] + ([y_in] if y_in is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("CUDA kernel takes contiguous tensors")
    nb, B, _ = blocks.shape
    if not 1 <= B <= MAX_BLOCK:
        raise ValueError(f"CUDA kernel takes block sizes 1..{MAX_BLOCK}, "
                         f"got {B}")
    y = torch.empty_like(x)
    lib = _build.library("block_diag_spmm")
    with torch.cuda.device(x.device):
        lib.launch(blocks.data_ptr(), x.data_ptr(),
                   y_in.data_ptr() if y_in is not None else None,
                   y.data_ptr(), nb, B, x.shape[1], DTYPE_CODES[x.dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    launches.add()
    return y
