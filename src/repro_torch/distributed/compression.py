"""Gradient compression hooks (off by default).

Counterpart of ``repro/distributed/compression.py``.  Methods:
  none     -- identity
  bf16     -- cast gradients to bf16 and back: halves the bytes a
              gradient collective would move; the optimizer re-expands to
              fp32
  topk_ef  -- per-tensor magnitude top-k sparsification with error feedback
              (the dropped residual is carried to the next step), Deep
              Gradient Compression style (arXiv:1712.01887)

The hook sits between the gradients and the optimizer inside the train
step (``train/steps.py``).  The port trains on one device, so nothing
crosses a data axis: the hook changes the numbers exactly as the
reference's does, and saves no bytes.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def topk_threshold(acc: torch.Tensor, topk_frac: float) -> torch.Tensor:
    """The k-th largest |acc|, k = max(int(n * topk_frac), 1)."""
    flat = acc.reshape(-1).abs()
    k = max(int(flat.shape[0] * topk_frac), 1)
    return torch.topk(flat, k, sorted=False).values.min()


def compress(grads, method: str = "none", ef_state=None,
             topk_frac: float = 0.01):
    """Returns (compressed_grads, new_ef_state)."""
    if method == "none":
        return grads, ef_state
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype),
                        grads), ef_state
    if method == "topk_ef":
        if ef_state is None:
            raise ValueError("topk_ef needs the error-feedback state "
                             "(init_error_feedback)")

        def one(g, e):
            acc = g.to(torch.float32) + e
            mask = acc.abs() >= topk_threshold(acc, topk_frac)
            sent = torch.where(mask, acc, 0.0)
            return sent.to(g.dtype), acc - sent

        outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                          tree_leaves(ef_state))]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(grads, [o[1] for o in outs]))
    raise ValueError(method)
