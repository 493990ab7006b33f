"""Rotary position embeddings: standard RoPE and multi-modal M-RoPE
(Qwen2-VL, arXiv:2409.12191 section 2.1), and Whisper's fixed sinusoidal
table (counterpart of ``repro/layers/rope.py``)."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float = 10000.0,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) with the two halves of its head dim (x1 = x[...,
    :D/2], x2 = x[..., D/2:]) rotated against each other by the angles
    ``ang`` (B, S, D/2), in float32, cast back to x's dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotates the two halves of
    the head dim against each other (x1 = x[..., :D/2], x2 = x[..., D/2:]),
    as the reference's code does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (d/2,)
    return _rotate(x, positions[..., None].float() * freqs)  # (B, S, d/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...],
                theta: float = 10000.0) -> torch.Tensor:
    """M-RoPE: positions (3, B, S) for (temporal, height, width); the head
    dim's frequency bands are split by ``sections`` (in d/2 units, e.g.
    (16, 24, 24) for D = 128), the first ``sections[0]`` frequencies
    rotating by the temporal stream, the next ``sections[1]`` by the
    height stream, the rest by the width stream.  With three equal streams
    it is ``apply_rope``."""
    d = x.shape[-1]
    if len(sections) != 3 or sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must be three "
                         f"bands summing to head_dim / 2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    # each frequency's stream, the reference's repeat(arange(3), sections),
    # made on the device (a repeat by a device tensor waits for the device
    # to size its output)
    i = torch.arange(d // 2, device=x.device)
    band = (i >= sections[0]).long() + (i >= sections[0] + sections[1]).long()
    pos = positions.float().index_select(0, band).movedim(0, -1)  # B,S,d/2
    return _rotate(x, pos * freqs)


def sinusoidal_positions(n: int, d: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, (n, d) float32: row p
    holds sin(p / 10000^(2i/d)) in column 2i and cos of the same angle in
    column 2i + 1 (interleaved, not two halves).  The denominators are
    10000^(2i/d) rounded once to float32 (the power taken in float64): the
    reference's power is correctly rounded, torch's float32 one is not
    always (11 of d = 1280's 640 are one ulp off, which moves sin at
    position 1500 by 3e-5)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d).double()).float()
    out = torch.zeros((n, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out
