"""Neural-net primitives: inits, norms, embeddings, cross-entropy.

Counterpart of ``repro/layers/nn.py``.  Parameters are plain dicts of
tensors.  ``jax.random`` keys become explicit ``torch.Generator``s: every
init draws from the generator it is given, on that generator's device, so
a model's parameters are made where they will live.  The two frameworks
draw different numbers from one seed; a comparison of the two packages
carries the reference's parameters over (``repro_torch.weights``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def trunc_normal(gen: torch.Generator, shape, std: float = 0.02,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal draws truncated to [-2, 2], times ``std``, on ``gen``'s
    device."""
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def lecun_normal(gen: torch.Generator, shape,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    return (torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
            * math.sqrt(1.0 / fan_in))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (a gather, as the reference's
    ``jnp.take``)."""
    return table[ids.long()]


def embed_lookup_onehot(table: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` as a one-hot product (the reference's
    form for vocab-sharded tables), in ``table``'s dtype."""
    oh = F.one_hot(ids.long(), table.shape[0]).to(table.dtype)
    return oh @ table


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over mask; logits (..., V) in any dtype, computed in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
