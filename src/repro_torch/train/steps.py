"""Train, prefill and serve step factories (counterpart of
``repro/train/steps.py``).

The reference jits these; PyTorch runs them eagerly.  The train step
takes its gradients with ``torch.autograd.grad`` over the leaves of the
params tree; the prefill and serve steps run without autograd.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import compression
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_unflatten


def _split(key: str, x, accum_steps: int) -> list:
    """``accum_steps`` micro-batches of one batch entry: dim 0 split, dim 1
    for ``positions`` ((3, B, S)); None and 0-d entries repeat."""
    if x is None or x.dim() == 0:
        return [x] * accum_steps
    dim = 1 if key == "positions" else 0
    b = x.shape[dim]
    if b % accum_steps:
        raise ValueError(f"batch[{key!r}] has {b} rows on dim {dim}, not a "
                         f"multiple of accum_steps={accum_steps}")
    return list(torch.chunk(x, accum_steps, dim=dim))


def make_train_step(cfg: lm.ModelConfig, opt_cfg: adamw.OptConfig,
                    accum_steps: int = 1, grad_compression: str = "none"):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``
    (0-d tensors).

    accum_steps > 1 splits the global batch into micro-batches run one
    after another (the activation-memory lever); their gradients add up in
    float32 and loss, metrics and gradients are scaled by 1/accum_steps.
    With accum_steps = 1 the gradients keep the params' dtypes, as in the
    reference.  With compression on, ``opt_state["ef"]`` (the error
    feedback, ``compression.init_error_feedback``) is carried.  The
    returned params and state are new tensors; the inputs are not
    modified."""

    def micro(params, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_()
                      for p in tree_leaves(params)]
            loss, metrics = lm.loss_fn(
                tree_unflatten(params, leaves), cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def step(params, opt_state, batch):
        if accum_steps == 1:
            loss, metrics, grads = micro(params, batch)
        else:
            parts = {k: _split(k, v, accum_steps) for k, v in batch.items()}
            loss = metrics = grads = None
            for i in range(accum_steps):
                l_i, m_i, g_i = micro(params, {k: v[i]
                                               for k, v in parts.items()})
                if grads is None:
                    loss, metrics = l_i, m_i
                    grads = [g.to(torch.float32) for g in g_i]
                else:
                    loss = loss + l_i
                    metrics = {k: metrics[k] + m_i[k] for k in metrics}
                    grads = [a + g for a, g in zip(grads, g_i)]
                del g_i
            inv = 1.0 / accum_steps
            loss = loss * inv
            metrics = {k: m * inv for k, m in metrics.items()}
            grads = [g * inv for g in grads]
        grads = tree_unflatten(params, grads)

        ef = None
        if grad_compression != "none":
            grads, ef = compression.compress(grads, grad_compression,
                                             opt_state.get("ef"))
        new_params, new_opt, stats = adamw.update(params, grads, opt_state,
                                                  opt_cfg)
        if ef is not None:
            new_opt["ef"] = ef
        return new_params, new_opt, dict(loss=loss, **metrics, **stats)

    return step


def make_prefill_step(cfg: lm.ModelConfig):
    """Prompt-processing forward: logits for every position (the serving
    prefill compute shape).  With ``attn_core="flash"`` each layer's
    attention is the flash kernel when S % 128 == 0; with
    ``wkv_core="pallas"`` each RWKV-6 layer's recurrence is the
    rwkv6_chunked kernel when T % rwkv_chunk == 0 and T > rwkv_chunk."""

    @torch.no_grad()
    def step(params, batch):
        logits, _ = lm.forward(params, cfg, batch)
        return logits

    return step


def make_serve_step(cfg: lm.ModelConfig):
    """One decode step: new token in, next token + updated caches out (the
    caches are updated in place and returned)."""

    @torch.no_grad()
    def step(params, caches, tokens, pos):
        logits, next_tok, caches = lm.decode_step(params, cfg, caches,
                                                  tokens, pos)
        return next_tok, logits, caches

    return step
