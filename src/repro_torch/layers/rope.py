"""Rotary position embeddings (counterpart of ``repro/layers/rope.py``).

Standard RoPE only: M-RoPE and the sinusoidal table come with the models
that use them (ROADMAP section 1 item 8)."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float = 10000.0,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotates the two halves of
    the head dim against each other (x1 = x[..., :D/2], x2 = x[..., D/2:]),
    as the reference's code does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
