"""Plain PyTorch versions of the aggregation kernels.

Counterpart of the SpMM part of ``repro/kernels/ref.py``.  They are the
correctness references the CUDA kernels are held against on the card, and
what each wrapper runs when its tensors lie on the CPU.  Products
accumulate in float32 (float64 for float64 inputs, so gradients can be
checked numerically) and the result is cast back to the input dtype, as in
the reference; the dW reduction returns its accumulation type.
"""
from __future__ import annotations

import torch


def _acc(t: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: float32, or float64 for float64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def block_diag_spmm(blocks: torch.Tensor, x: torch.Tensor,
                    y_in: torch.Tensor | None = None, *,
                    transpose: bool = False) -> torch.Tensor:
    """Y[b*B:(b+1)*B] = blocks[b] @ x[b*B:(b+1)*B] (+ y_in); with
    ``transpose`` each block's transpose instead.

    blocks: (nb, B, B); x: (nb*B, F); y_in: optional (nb*B, F)."""
    nb, B, _ = blocks.shape
    acc = _acc(x)
    a = blocks.transpose(1, 2) if transpose else blocks
    y = torch.einsum("bij,bjf->bif", a.to(acc),
                     x.reshape(nb, B, -1).to(acc)).reshape(nb * B, -1)
    if y_in is not None:
        y = y_in.to(acc) + y
    return y.to(x.dtype)


def bell_spmm(blocks: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
              y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked-ELL SpMM: Y[i] = sum_k blocks[i,k] @ X[col_idx[i,k]] (+ y_in).

    blocks: (nbr, K, B, B); col_idx: (nbr, K) block-column ids;
    x: (n_cols_pad, F) -> (nbr*B, F).  Padding blocks are all-zero, so
    their contribution vanishes whatever col_idx names."""
    nbr, K, B, _ = blocks.shape
    acc = _acc(x)
    xb = x.reshape(-1, B, x.shape[-1]).to(acc)          # (nbc, B, F)
    gathered = xb[col_idx.long()]                       # (nbr, K, B, F)
    y = torch.einsum("rkij,rkjf->rif", blocks.to(acc),
                     gathered).reshape(nbr * B, -1)
    if y_in is not None:
        y = y_in.to(acc) + y
    return y.to(x.dtype)


def block_diag_spmm_fused(blocks: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, y_in: torch.Tensor | None = None,
                          *, transpose: bool = False) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) (+ y_in); with ``transpose`` each
    block's transpose.  x: (nb*B, Fi); w: (Fi, Fo) -> (nb*B, Fo)."""
    acc = _acc(x)
    h = x.to(acc) @ w.to(acc)
    y = block_diag_spmm(blocks.to(acc), h,
                        y_in.to(acc) if y_in is not None else None,
                        transpose=transpose)
    return y.to(x.dtype)


def bell_spmm_fused(blocks: torch.Tensor, col_idx: torch.Tensor,
                    x: torch.Tensor, w: torch.Tensor,
                    y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A_bell @ (x @ w) (+ y_in).  x: (n_cols_pad, Fi); w: (Fi, Fo).

    The transform runs once over x, then the blocked-ELL product gathers
    the (B, Fo) slices of H: the same function as the kernel's per-block
    transform, without a (nbr, K, B, Fi) gather."""
    acc = _acc(x)
    h = x.to(acc) @ w.to(acc)
    y = bell_spmm(blocks.to(acc), col_idx, h,
                  y_in.to(acc) if y_in is not None else None)
    return y.to(x.dtype)


def bell_spmm_dw(blocks_t: torch.Tensor, col_idx_t: torch.Tensor | None,
                 x: torch.Tensor, g: torch.Tensor, *,
                 transpose: bool = False) -> torch.Tensor:
    """dW = x^T @ (A^T @ g) with A^T in blocked-ELL (the transpose payload).

    blocks_t: (nbr, K, B, B), read transposed with ``transpose``;
    col_idx_t: (nbr, K) block columns of g, or None for identity columns
    (K = 1, the diagonal tier); x: (nbr*B, Fi); g: (n_cols_pad, Fo).
    Returns (Fi, Fo) in the accumulation dtype.  A^T g is formed at width
    Fo, so nothing of width Fi is gathered."""
    acc = _acc(x)
    if col_idx_t is None:
        col_idx_t = torch.arange(blocks_t.shape[0], dtype=torch.int32,
                                 device=blocks_t.device)[:, None]
    a = blocks_t.transpose(2, 3) if transpose else blocks_t
    z = bell_spmm(a.to(acc), col_idx_t, g.to(acc))      # (nbr*B, Fo)
    return x.to(acc).T @ z


def ell_spmm(indices: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Row-padded gather SpMM: Y[i] = sum_k vals[i,k] * x[indices[i,k]].

    indices/vals: (n, K) (vals zero where padded); x: (n_cols, F)."""
    gathered = x[indices.long()].float()               # (n, K, F)
    return torch.einsum("nk,nkf->nf", vals.float(), gathered).to(x.dtype)


def coo_spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Edge-parallel scatter-add."""
    msgs = x[cols.long()].float() * vals.float()[:, None]
    y = torch.zeros((n_rows, x.shape[-1]), dtype=torch.float32,
                    device=x.device)
    return y.index_add_(0, rows.long(), msgs).to(x.dtype)
