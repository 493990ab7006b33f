"""Selective SSM scan (Mamba, arXiv:2312.00752): Jamba's recurrent layer.

Counterpart of ``repro/kernels/mamba_scan.py``:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t . h_t + D x_t
from a zero state, x and dt (B, T, d_inner) with dt post-softplus, B and C
(B, T, d_state), A (d_inner, d_state), D (d_inner,).

``mamba_scan`` is the counterpart of the Pallas kernel: on CUDA tensors it
launches the hand kernel in ``csrc/mamba_scan.cu`` (design and bound in
its header), which walks T in order with each channel's d_state values in
the registers of 2 or 4 adjacent lanes and its inputs streamed through a
ring of copies in shared memory; on CPU tensors it runs the plain version
``ref.mamba_ssm`` (the sequential oracle).  There is no fallback
between the two: a CUDA input launches the kernel or raises.
``mamba_scan`` is forward only and raises where autograd would
differentiate its result; ``mamba_scan_trainable`` is the differentiable
form, the reference's ``_trainable``: the kernel forward, saving only its
inputs, and a backward that recomputes the output through the plain
sequential oracle ``ref.mamba_ssm`` under autograd and takes its VJP.
That backward is T steps of small torch ops, a few per step in each
direction: launch-bound on the card (``chip_smoke.py`` times it at
Jamba's widths), and its float32 states, one (B, d_inner, d_state) per
step, are what the recompute holds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.mamba_ssm
launches = _build.LaunchCount()
MAX_D_STATE = 16        # the CUDA kernel's limit on d_state


def _check(x, dt, Bc, Cc, A, D, chunk: int, d_tile: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, d_inner), got {tuple(x.shape)}")
    B, T, di = x.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A must be (d_inner={di}, d_state), got "
                         f"{tuple(A.shape)}")
    ds = A.shape[1]
    want = {"dt": (dt, (B, T, di)), "Bc": (Bc, (B, T, ds)),
            "Cc": (Cc, (B, T, ds)), "D": (D, (di,))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    # the reference's preconditions (mamba_scan.py:65-68); the result does
    # not depend on chunk or d_tile
    chunk, d_tile = min(chunk, T), min(d_tile, di)
    if chunk <= 0 or d_tile <= 0 or T % chunk or di % d_tile:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk} and "
                         f"d_inner={di} of d_tile={d_tile}")
    ts = (x, dt, Bc, Cc, A, D)
    if any(t.device != x.device for t in ts):
        raise ValueError("operands must lie on one device, got "
                         f"{[str(t.device) for t in ts]}")


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
               Cc: torch.Tensor, A: torch.Tensor, D: torch.Tensor, *,
               chunk: int = 128, d_tile: int = 512) -> torch.Tensor:
    """x, dt: (B, T, d_inner); Bc, Cc: (B, T, d_state); A: (d_inner,
    d_state); D: (d_inner,) -> y (B, T, d_inner) in x's dtype.  dt is
    post-softplus; T % min(chunk, T) == 0 and d_inner % min(d_tile,
    d_inner) == 0 (the reference's preconditions).  CUDA tensors must be
    contiguous, x float32 or bfloat16, the rest float32, d_state <= 16."""
    _check(x, dt, Bc, Cc, A, D, chunk, d_tile)
    _build.refuse_grad("mamba_scan", (x, dt, Bc, Cc, A, D),
                       "call mamba_scan_trainable")
    if x.device.type == "cpu":
        return plain(x, dt, A, Bc, Cc, D)
    code = _build.cuda_dtype_code((x,))
    rest = (dt, Bc, Cc, A, D)
    if any(t.dtype != torch.float32 for t in rest):
        raise ValueError("CUDA kernel takes float32 dt, Bc, Cc, A and D, got "
                         f"{[t.dtype for t in rest]}")
    if not all(t.is_contiguous() for t in rest):
        raise ValueError("CUDA kernel takes contiguous tensors")
    B, T, di = x.shape
    ds = A.shape[1]
    if not 1 <= ds <= MAX_D_STATE:
        raise ValueError(f"CUDA kernel takes 1 <= d_state <= {MAX_D_STATE}, "
                         f"got {ds}")
    y = torch.empty_like(x)
    lib = _build.library("mamba_scan")
    with torch.cuda.device(x.device):
        lib.launch(x.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                   A.data_ptr(), D.data_ptr(), y.data_ptr(), B, T, di, ds,
                   code, _build.stream(x))
    launches.add()
    return y


class _MambaTrainable(torch.autograd.Function):
    """The kernel forward; the backward recomputes the scan through plain
    ``ref.mamba_ssm`` (the reference's ``_trainable`` bwd: only the inputs
    are kept from the forward)."""

    @staticmethod
    def forward(ctx, x, dt, Bc, Cc, A, D):
        ctx.save_for_backward(x, dt, Bc, Cc, A, D)
        return mamba_scan(x, dt, Bc, Cc, A, D)

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            x, dt, Bc, Cc, A, D = leaves
            y = ref.mamba_ssm(x, dt, A, Bc, Cc, D)
        return torch.autograd.grad(y, leaves, dy)


def mamba_scan_trainable(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                         Cc: torch.Tensor, A: torch.Tensor,
                         D: torch.Tensor) -> torch.Tensor:
    """Differentiable selective scan: kernel forward (``mamba_scan``'s
    arguments and preconditions, its default chunk and d_tile), recompute
    backward through the plain sequential oracle."""
    return _MambaTrainable.apply(x, dt, Bc, Cc, A, D)


def mamba_scan_hbm_bytes(B, T, di, ds, d_tile: int = 512,
                         bytes_el: int = 4) -> int:
    """Streaming floor: x/dt/y once; B/C rereads per d-tile; A/D once."""
    xy = 3 * B * T * di * bytes_el
    bc = 2 * B * T * ds * (di // d_tile) * bytes_el
    return xy + bc + di * ds * bytes_el


def mamba_scan_flops(B, T, di, ds) -> float:
    """exp + 3 muls + add per (t, d, s) for the recurrence, plus the C
    contraction and D skip: ~8 flops per state element."""
    return 8.0 * B * T * di * ds
