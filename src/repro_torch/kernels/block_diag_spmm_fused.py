"""Fused block-diagonal transform+aggregate: Y = blockdiag(A) @ (X W) (+ Y_in),
and its dual-weight (SAGE) form Y = blockdiag(A) @ (X W) + X W_self (+ Y_in).

Replaces the Pallas TPU kernels of ``repro/kernels/block_diag_spmm_fused.py``
(``block_diag_spmm_fused`` and ``block_diag_spmm_dual``).  On CUDA tensors
the wrappers launch hand kernels: the single-weight form is
``csrc/bell_spmm_fused.cu`` with K = 1 and identity block columns, the
dual form ``csrc/block_diag_spmm_dual.cu`` (design and bound in their
headers).  On CPU tensors they run the plain versions
``ref.block_diag_spmm_fused`` and ``ref.block_diag_spmm_dual``.  There is
no fallback between the two: a CUDA input launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, bell_spmm_fused, ref

plain = ref.block_diag_spmm_fused
plain_dual = ref.block_diag_spmm_dual
launches = _build.LaunchCount()
dual_launches = _build.LaunchCount()


def _check(blocks, x, w, y_in, w_self=None) -> None:
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be (nb, B, B), got {tuple(blocks.shape)}")
    nb, B, _ = blocks.shape
    if x.dim() != 2 or x.shape[0] != nb * B:
        raise ValueError(f"x must be ({nb * B}, Fi) for blocks "
                         f"{tuple(blocks.shape)}, got {tuple(x.shape)}")
    if w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be ({x.shape[1]}, Fo), got {tuple(w.shape)}")
    if w_self is not None and w_self.shape != w.shape:
        raise ValueError(f"w_self must be {tuple(w.shape)} like w, "
                         f"got {tuple(w_self.shape)}")
    if y_in is not None and tuple(y_in.shape) != (nb * B, w.shape[1]):
        raise ValueError(f"y_in must be {(nb * B, w.shape[1])}, "
                         f"got {tuple(y_in.shape)}")
    _build.check_operands((x, blocks, w, w_self, y_in))


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


def block_diag_spmm_dual(blocks: torch.Tensor, x: torch.Tensor,
                         w: torch.Tensor, w_self: torch.Tensor,
                         y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) + x @ w_self (+ y_in), float32
    accumulation, both transforms taken from one on-chip copy of each
    block's rows of x.  Returns (nb*B, Fo).

    blocks: (nb, B, B); x: (nb*B, Fi); w, w_self: (Fi, Fo); y_in:
    optional (nb*B, Fo).  CUDA tensors must be contiguous float32 or
    bfloat16 with B <= 64."""
    _check(blocks, x, w, y_in, w_self)
    if x.device.type == "cpu":
        return plain_dual(blocks, x, w, w_self, y_in)
    nb, B, _ = blocks.shape
    code = _build.cuda_dtype_code((x, blocks, w, w_self, y_in),
                                  block_size=B)
    Fi, Fo = w.shape
    y = torch.empty((nb * B, Fo), dtype=x.dtype, device=x.device)
    lib = _build.library("block_diag_spmm_dual")
    with torch.cuda.device(x.device):
        lib.launch(blocks.data_ptr(), x.data_ptr(), w.data_ptr(),
                   w_self.data_ptr(), _build.ptr(y_in), y.data_ptr(), nb, B,
                   Fi, Fo, code, _build.stream(x))
    dual_launches.add()
    return y
