"""Plain PyTorch versions of the aggregation kernels.

Counterpart of the SpMM part of ``repro/kernels/ref.py``.  They are the
correctness references the CUDA kernels are held against on the card, and
what each wrapper runs when its tensors lie on the CPU.  Products
accumulate in float32 and the result is cast back to the input dtype, as
in the reference.
"""
from __future__ import annotations

import torch


def block_diag_spmm(blocks: torch.Tensor, x: torch.Tensor,
                    y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y[b*B:(b+1)*B] = blocks[b] @ x[b*B:(b+1)*B] (+ y_in).

    blocks: (nb, B, B); x: (nb*B, F); y_in: optional (nb*B, F)."""
    nb, B, _ = blocks.shape
    y = torch.einsum("bij,bjf->bif", blocks.float(),
                     x.reshape(nb, B, -1).float()).reshape(nb * B, -1)
    if y_in is not None:
        y = y_in.float() + y
    return y.to(x.dtype)


def bell_spmm(blocks: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
              y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked-ELL SpMM: Y[i] = sum_k blocks[i,k] @ X[col_idx[i,k]] (+ y_in).

    blocks: (nbr, K, B, B); col_idx: (nbr, K) block-column ids;
    x: (n_cols_pad, F) -> (nbr*B, F).  Padding blocks are all-zero, so
    their contribution vanishes whatever col_idx names."""
    nbr, K, B, _ = blocks.shape
    xb = x.reshape(-1, B, x.shape[-1]).float()          # (nbc, B, F)
    gathered = xb[col_idx.long()]                       # (nbr, K, B, F)
    y = torch.einsum("rkij,rkjf->rif", blocks.float(),
                     gathered).reshape(nbr * B, -1)
    if y_in is not None:
        y = y_in.float() + y
    return y.to(x.dtype)


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
