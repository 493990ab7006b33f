"""Fused blocked-ELL transform+aggregate, Y = A_bell @ (X W) (+ Y_in), and
the fused kernels' weight gradient dW = X^T (A^T G).

Replaces the Pallas TPU kernels of ``repro/kernels/bell_spmm_fused.py``
(``bell_spmm_fused`` and ``bell_spmm_dw``).  On CUDA tensors the wrappers
launch the hand kernels in ``csrc/bell_spmm_fused.cu`` and
``csrc/bell_spmm_dw.cu`` (design and bound in their headers); on CPU
tensors they run the plain versions ``ref.bell_spmm_fused`` and
``ref.bell_spmm_dw``.  There is no fallback between the two: a CUDA input
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.bell_spmm_fused
plain_dw = ref.bell_spmm_dw
launches = _build.LaunchCount()
dw_launches = _build.LaunchCount()

# block rows per partial sum of bell_spmm_dw: fixed, so the order of the
# reduction (and the result's bits) does not depend on the card
DW_ROWS_PER_SPLIT = 8


def _check_bell(blocks, col_idx, n_valid) -> None:
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be (nbr, K, B, B), "
                         f"got {tuple(blocks.shape)}")
    nbr, K = blocks.shape[:2]
    if col_idx is not None and tuple(col_idx.shape) != (nbr, K):
        raise ValueError(f"col_idx must be {(nbr, K)}, "
                         f"got {tuple(col_idx.shape)}")
    if n_valid is not None and tuple(n_valid.shape) != (nbr,):
        raise ValueError(f"n_valid must be {(nbr,)}, "
                         f"got {tuple(n_valid.shape)}")


def bell_spmm_fused(blocks: torch.Tensor, col_idx: torch.Tensor,
                    x: torch.Tensor, w: torch.Tensor,
                    y_in: torch.Tensor | None = None,
                    n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A_bell @ (x @ w) (+ y_in), float32 accumulation, with each
    stored block transforming its gathered rows of x on chip.  Returns
    (nbr*B, Fo).

    blocks: (nbr, K, B, B); col_idx: (nbr, K) int32 block columns of x;
    x: (n_cols, Fi); w: (Fi, Fo); y_in: optional (nbr*B, Fo); ``n_valid``
    (nbr,) int32, when given, the number of real (leading) slots per block
    row.  CUDA tensors must be contiguous float32 or bfloat16, B <= 64."""
    _check_bell(blocks, col_idx, n_valid)
    nbr, K, B, _ = blocks.shape
    if x.dim() != 2 or x.shape[0] % B:
        raise ValueError(f"x must be (n_cols, Fi) with n_cols a multiple of "
                         f"{B}, got {tuple(x.shape)}")
    if w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be ({x.shape[1]}, Fo), got {tuple(w.shape)}")
    if y_in is not None and tuple(y_in.shape) != (nbr * B, w.shape[1]):
        raise ValueError(f"y_in must be {(nbr * B, w.shape[1])}, "
                         f"got {tuple(y_in.shape)}")
    _build.check_operands((x, blocks, w, y_in), (col_idx, n_valid))
    if x.device.type == "cpu":
        return plain(blocks, col_idx, x, w, y_in)
    y = launch_fused(blocks, col_idx, n_valid, x, w, y_in)
    launches.add()
    return y


def launch_fused(blocks, col_idx, n_valid, x, w, y_in, *,
                 transpose: bool = False) -> torch.Tensor:
    """Launch ``csrc/bell_spmm_fused.cu`` on checked CUDA operands and
    return Y; the caller counts the launch.  ``col_idx`` None means
    identity block columns (K = 1), the block-diagonal form."""
    nbr, K, B, _ = blocks.shape
    code = _build.cuda_dtype_code((x, blocks, w, y_in), (col_idx, n_valid),
                                  block_size=B)
    Fi, Fo = w.shape
    y = torch.empty((nbr * B, Fo), dtype=x.dtype, device=x.device)
    lib = _build.library("bell_spmm_fused")
    with torch.cuda.device(x.device):
        lib.launch(blocks.data_ptr(), _build.ptr(col_idx), _build.ptr(n_valid),
                   x.data_ptr(), w.data_ptr(), _build.ptr(y_in), y.data_ptr(),
                   nbr, K, B, Fi, Fo, int(transpose), code, _build.stream(x))
    return y


def bell_spmm_dw(blocks_t: torch.Tensor, col_idx_t: torch.Tensor | None,
                 x: torch.Tensor, g: torch.Tensor,
                 n_valid: torch.Tensor | None = None, *,
                 transpose: bool = False) -> torch.Tensor:
    """dW = x^T @ (A^T @ g), A^T given as the blocked-ELL transpose
    payload.  Returns (Fi, Fo) float32 (float64 for float64 CPU inputs).

    blocks_t: (nbr, K, B, B), read transposed with ``transpose`` (no copy
    is made); col_idx_t: (nbr, K) int32 block columns of g, or None for
    identity block columns (K = 1: the diagonal tier); x: (nbr*B, Fi);
    g: (n_cols, Fo); ``n_valid`` as in :func:`bell_spmm_fused`.  On CUDA
    the block rows are summed in a fixed order, without atomics, so the
    result is the same on every run."""
    _check_bell(blocks_t, col_idx_t, n_valid)
    nbr, K, B, _ = blocks_t.shape
    if col_idx_t is None and K != 1:
        raise ValueError(f"identity block columns need K = 1, got K = {K}")
    if x.dim() != 2 or x.shape[0] != nbr * B:
        raise ValueError(f"x must be ({nbr * B}, Fi), got {tuple(x.shape)}")
    if g.dim() != 2 or g.shape[0] % B or (col_idx_t is None
                                          and g.shape[0] != nbr * B):
        raise ValueError(f"g must be (n_cols, Fo) with n_cols a multiple of "
                         f"{B} ({nbr * B} for identity columns), "
                         f"got {tuple(g.shape)}")
    _build.check_operands((x, blocks_t, g), (col_idx_t, n_valid))
    if x.device.type == "cpu":
        return plain_dw(blocks_t, col_idx_t, x, g, transpose=transpose)
    code = _build.cuda_dtype_code((x, blocks_t, g), (col_idx_t, n_valid),
                                  block_size=B)
    Fi, Fo = x.shape[1], g.shape[1]
    n_split = -(-nbr // DW_ROWS_PER_SPLIT)
    partial = torch.empty((n_split, Fi, Fo), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((Fi, Fo), dtype=torch.float32, device=x.device)
    lib = _build.library("bell_spmm_dw")
    with torch.cuda.device(x.device):
        lib.launch(blocks_t.data_ptr(), _build.ptr(col_idx_t),
                   _build.ptr(n_valid), x.data_ptr(), g.data_ptr(),
                   partial.data_ptr(), dw.data_ptr(), nbr, K, B, Fi, Fo,
                   DW_ROWS_PER_SPLIT, int(transpose), code, _build.stream(x))
    dw_launches.add()
    return dw
