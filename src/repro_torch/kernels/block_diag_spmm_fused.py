"""Fused block-diagonal transform+aggregate: Y = blockdiag(A) @ (X W) (+ Y_in).

Replaces the Pallas TPU kernel ``repro/kernels/block_diag_spmm_fused.py``
(``block_diag_spmm_fused``).  On CUDA tensors the wrapper launches the
hand kernel of ``csrc/bell_spmm_fused.cu`` with K = 1 and identity block
columns, which is this function (design and bound in its header); on CPU
tensors it runs the plain version ``ref.block_diag_spmm_fused``.  There is
no fallback between the two: a CUDA input launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, bell_spmm_fused, ref

plain = ref.block_diag_spmm_fused
launches = _build.LaunchCount()


def _check(blocks, x, w, y_in) -> None:
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be (nb, B, B), got {tuple(blocks.shape)}")
    nb, B, _ = blocks.shape
    if x.dim() != 2 or x.shape[0] != nb * B:
        raise ValueError(f"x must be ({nb * B}, Fi) for blocks "
                         f"{tuple(blocks.shape)}, got {tuple(x.shape)}")
    if w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be ({x.shape[1]}, Fo), got {tuple(w.shape)}")
    if y_in is not None and tuple(y_in.shape) != (nb * B, w.shape[1]):
        raise ValueError(f"y_in must be {(nb * B, w.shape[1])}, "
                         f"got {tuple(y_in.shape)}")
    _build.check_operands((x, blocks, w, y_in))


def block_diag_spmm_fused(blocks: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, y_in: torch.Tensor | None = None,
                          *, transpose: bool = False) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) (+ y_in), float32 accumulation, with
    H = x @ w formed on chip only; with ``transpose`` each block is read
    transposed (no copy is made).  Returns (nb*B, Fo).

    blocks: (nb, B, B); x: (nb*B, Fi); w: (Fi, Fo); y_in: optional
    (nb*B, Fo).  CUDA tensors must be contiguous float32 or bfloat16 with
    B <= 64."""
    _check(blocks, x, w, y_in)
    if x.device.type == "cpu":
        return plain(blocks, x, w, y_in, transpose=transpose)
    y = bell_spmm_fused.launch_fused(blocks.unsqueeze(1), None, None, x, w,
                                     y_in, transpose=transpose)
    launches.add()
    return y
