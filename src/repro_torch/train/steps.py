"""Prefill and serve step factories (counterpart of
``repro/train/steps.py``).

The reference jits these; PyTorch runs them eagerly.  Both run without
autograd.  ``make_train_step`` comes with the LM training slice (with
``optim/adamw.py`` and ``distributed/compression.py``; ROADMAP section 1
item 8).
"""
from __future__ import annotations

import torch

from repro_torch.models import lm


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
