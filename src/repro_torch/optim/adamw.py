"""AdamW + cosine schedule + global-norm clipping, plain functions over
trees of tensors.

Counterpart of ``repro/optim/adamw.py``, over trees of tensors
(:mod:`repro_torch.tree`: the LM's params, ``models/lm.py``).  Moments are
float32; params keep their dtype (a bfloat16 param updates in float32 and
rounds back).  ``step`` is a 0-d int32 tensor on the params' device.

This is the reference's AdamW, not ``torch.optim.AdamW``: the bias
correction, the decay (added to the normalised step, both times the
scheduled lr) and the clipping before the moments are the reference's.
Nothing is updated in place: ``update`` returns new tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac*lr (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return dict(
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def state_specs(param_specs):
    return dict(m=param_specs, v=param_specs, step=())


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


@torch.no_grad()
def update(params, grads, state, cfg: OptConfig):
    """One AdamW step.  Moments in fp32; params keep their own dtype
    (bf16 params + fp32 moments = mixed-precision training standard).
    Returns (new params, new state, dict(grad_norm=, lr=))."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        pf = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, dict(m=new_m, v=new_v, step=step), dict(grad_norm=gnorm,
                                                          lr=lr)
