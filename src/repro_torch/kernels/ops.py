"""Aggregation entry points over format payloads, with their gradients.

Counterpart of ``repro/kernels/ops.py``.  ``block_diag_*`` and ``bell_*``
reach the hand CUDA kernels on CUDA tensors and their plain versions on
CPU tensors; ``ell``/``coo`` are plain PyTorch gather and ``index_add_`` on
any device, differentiable by autograd.  The TPU's 128-lane feature padding
and feature tiling are not carried over: the CUDA kernels take any width.

Each ``torch.autograd.Function`` mirrors one of the reference's
``custom_vjp``s.  Aggregation Y = A X is linear in X, so dX = A^T dY: the
block-diagonal kernel with its transposed-read flag, or the blocked-ELL
kernel over the transpose payload ``bell_t`` materialized at decomposition.
The fused forms Y = A (X W) have dX = A^T (dY W^T), the same fused kernel
over the transpose, and dW = X^T (A^T dY), one blocked reduction
(``bell_spmm_dw``; the diagonal tier with K = 1 and identity columns).
SAGE's dual form Y = A (X W) + X W_self adds dY W_self^T to dX and
dW_self = X^T dY, two dense products.  A gradient is computed only when
autograd asks for it (``ctx.needs_input_grad``): a first layer's raw
features need no dX.  The
``_acc`` variants pass dY through to ``y_in``.  The graph is not trained:
payloads get no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core import formats
from repro_torch.kernels import ref
from repro_torch.kernels.bell_spmm import bell_spmm
from repro_torch.kernels.bell_spmm_fused import bell_spmm_dw, bell_spmm_fused
from repro_torch.kernels.block_diag_spmm import block_diag_spmm
from repro_torch.kernels.block_diag_spmm_fused import (block_diag_spmm_dual,
                                                      block_diag_spmm_fused)


def _bell_dx(ctx, bell_t: formats.BlockELL, dy: torch.Tensor,
             w: torch.Tensor | None = None) -> torch.Tensor:
    """A^T dY (or A^T (dY W^T)) over the transpose payload, cut to the
    forward input's rows."""
    if w is None:
        dx = bell_spmm(bell_t.blocks, bell_t.col_idx, dy,
                       n_valid=bell_t.n_valid)
    else:
        dx = bell_spmm_fused(bell_t.blocks, bell_t.col_idx, dy,
                             w.t().contiguous(), n_valid=bell_t.n_valid)
    return dx[: ctx.n_in].to(ctx.x_dtype)


class _BlockDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, x, y_in):
        ctx.save_for_backward(blocks)
        return block_diag_spmm(blocks, x.contiguous(), y_in)

    @staticmethod
    def backward(ctx, dy):
        blocks, = ctx.saved_tensors
        dx = (block_diag_spmm(blocks, dy.contiguous(), transpose=True)
              if ctx.needs_input_grad[1] else None)
        return None, dx, dy if ctx.needs_input_grad[2] else None


class _Bell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bell, bell_t, x, y_in):
        ctx.bell_t, ctx.n_in, ctx.x_dtype = bell_t, x.shape[0], x.dtype
        return bell_spmm(bell.blocks, bell.col_idx, x.contiguous(), y_in,
                         n_valid=bell.n_valid)

    @staticmethod
    def backward(ctx, dy):
        dx = (_bell_dx(ctx, ctx.bell_t, dy.contiguous())
              if ctx.needs_input_grad[2] else None)
        return None, None, dx, dy if ctx.needs_input_grad[3] else None


class _BlockDiagFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, x, w, y_in):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(blocks, x, w)
        return block_diag_spmm_fused(blocks, x, w, y_in)

    @staticmethod
    def backward(ctx, dy):
        blocks, x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:                 # A^T (dY W^T), fused
            dx = block_diag_spmm_fused(blocks, dy, w.t().contiguous(),
                                       transpose=True).to(x.dtype)
        if ctx.needs_input_grad[2]:                 # X^T (A^T dY)
            dw = bell_spmm_dw(blocks.unsqueeze(1), None, x, dy,
                              transpose=True).to(w.dtype)
        return None, dx, dw, dy if ctx.needs_input_grad[3] else None


class _BlockDiagDual(torch.autograd.Function):
    """Y = blockdiag(A) (X W) + X W_self (+ Y_in), as the reference's
    ``_bdd_bwd_terms``: dX = A^T (dY W^T) + dY W_self^T (the fused kernel
    over the transposed blocks plus a dense product), dW = X^T (A^T dY)
    (the diagonal dW kernel), dW_self = X^T dY (dense, accumulated in
    float32)."""

    @staticmethod
    def forward(ctx, blocks, x, w, w_self, y_in):
        x, w, w_self = x.contiguous(), w.contiguous(), w_self.contiguous()
        ctx.save_for_backward(blocks, x, w, w_self)
        return block_diag_spmm_dual(blocks, x, w, w_self, y_in)

    @staticmethod
    def backward(ctx, dy):
        blocks, x, w, w_self = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = dws = None
        if ctx.needs_input_grad[1]:
            dx = (block_diag_spmm_fused(blocks, dy, w.t().contiguous(),
                                        transpose=True)
                  + dy @ w_self.t().to(dy.dtype)).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dw = bell_spmm_dw(blocks.unsqueeze(1), None, x, dy,
                              transpose=True).to(w.dtype)
        if ctx.needs_input_grad[3]:
            acc = torch.promote_types(x.dtype, torch.float32)
            dws = (x.to(acc).t() @ dy.to(acc)).to(w_self.dtype)
        return (None, dx, dw, dws,
                dy if ctx.needs_input_grad[4] else None)


class _BellFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bell, bell_t, x, w, y_in):
        x, w = x.contiguous(), w.contiguous()
        ctx.bell_t, ctx.n_in, ctx.x_dtype = bell_t, x.shape[0], x.dtype
        ctx.save_for_backward(x, w)
        return bell_spmm_fused(bell.blocks, bell.col_idx, x, w, y_in,
                               n_valid=bell.n_valid)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        bell_t = ctx.bell_t
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[2]:
            dx = _bell_dx(ctx, bell_t, dy, w)
        if ctx.needs_input_grad[3]:
            dw = bell_spmm_dw(bell_t.blocks, bell_t.col_idx, x, dy,
                              n_valid=bell_t.n_valid).to(w.dtype)
        return (None, None, dx, dw,
                dy if ctx.needs_input_grad[4] else None)


def block_diag_matvec(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ x."""
    return _BlockDiag.apply(blocks, x, None)


def block_diag_matvec_acc(blocks: torch.Tensor, x: torch.Tensor,
                          y_in: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ x + y_in (accumulating dispatch mode).
    ``y_in`` may be one row repeated (strides (0, 1), as ``bias.expand``
    gives): the kernel reads that row, and no (n, F) copy is made."""
    return _BlockDiag.apply(blocks, x, y_in)


def bell_matvec(bell: formats.BlockELL, bell_t: formats.BlockELL,
                x: torch.Tensor) -> torch.Tensor:
    """Y = A_bell @ x.  ``bell_t`` is the transpose payload the backward
    pass runs over."""
    return _Bell.apply(bell, bell_t, x, None)


def bell_matvec_acc(bell: formats.BlockELL, bell_t: formats.BlockELL,
                    x: torch.Tensor, y_in: torch.Tensor) -> torch.Tensor:
    """Y = A_bell @ x + y_in (accumulating dispatch mode)."""
    return _Bell.apply(bell, bell_t, x, y_in.contiguous())


def block_diag_fused_matvec(blocks: torch.Tensor, x: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w), one fused kernel."""
    return _BlockDiagFused.apply(blocks, x, w, None)


def block_diag_fused_matvec_acc(blocks: torch.Tensor, x: torch.Tensor,
                                w: torch.Tensor,
                                y_in: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) + y_in, one fused kernel."""
    return _BlockDiagFused.apply(blocks, x, w, y_in.contiguous())


def block_diag_dual_matvec(blocks: torch.Tensor, x: torch.Tensor,
                           w: torch.Tensor,
                           w_self: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) + x @ w_self, one dual-weight kernel
    (SAGE's epilogue on the diagonal tier)."""
    return _BlockDiagDual.apply(blocks, x, w, w_self, None)


def block_diag_dual_matvec_acc(blocks: torch.Tensor, x: torch.Tensor,
                               w: torch.Tensor, w_self: torch.Tensor,
                               y_in: torch.Tensor) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) + x @ w_self + y_in."""
    return _BlockDiagDual.apply(blocks, x, w, w_self, y_in.contiguous())


def bell_fused_matvec(bell: formats.BlockELL, bell_t: formats.BlockELL,
                      x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Y = A_bell @ (x @ w), one fused kernel."""
    return _BellFused.apply(bell, bell_t, x, w, None)


def bell_fused_matvec_acc(bell: formats.BlockELL, bell_t: formats.BlockELL,
                          x: torch.Tensor, w: torch.Tensor,
                          y_in: torch.Tensor) -> torch.Tensor:
    """Y = A_bell @ (x @ w) + y_in, one fused kernel."""
    return _BellFused.apply(bell, bell_t, x, w, y_in.contiguous())


def ell_matvec(ell: formats.ELL, x: torch.Tensor) -> torch.Tensor:
    """Padded-neighbor gather (vertex-parallel CSR analogue)."""
    return ref.ell_spmm(ell.indices, ell.vals, x)


def coo_matvec(coo: formats.COO, x: torch.Tensor) -> torch.Tensor:
    """Edge-parallel scatter-add through ``index_add_``."""
    return ref.coo_spmm(coo.rows, coo.cols, coo.vals, x, coo.n_rows)


def coo_transform_matvec(coo: formats.COO, x: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """Y = A_coo @ (x @ w) without forming H = x @ w: each edge transforms
    only its gathered source row, (E, Fi) @ (Fi, Fo), and ``index_add_``
    sums the weighted rows in float32.  The spill tier of the budget-capped
    fused payloads (E is the overflow the cap rejected).  Plain torch ops,
    differentiated by autograd, as the reference's XLA form is."""
    h_e = ((x.index_select(0, coo.cols.long()) @ w).float()
           * coo.vals.float()[:, None])
    y = torch.zeros((coo.n_rows, w.shape[-1]), dtype=torch.float32,
                    device=x.device)
    return y.index_add_(0, coo.rows.long(), h_e).to(x.dtype)
