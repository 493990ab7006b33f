"""Flash (blockwise-softmax) attention with grouped-query heads.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``).  On CUDA tensors the wrapper launches the hand
kernel in ``csrc/flash_attention.cu`` (design and bound in its header); on
CPU tensors it runs the plain version ``ref.flash_attention``.  There is
no fallback between the two: a CUDA input launches the kernel or raises.

The causal mask keeps ``q_pos >= k_pos`` counted from the top left, as the
Pallas kernel masks; ``ref.mha`` aligns its mask to the bottom right.  The
two agree when causal is off or Sq == Skv.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.flash_attention
launches = _build.LaunchCount()
MAX_HEAD_DIM = 256      # the CUDA kernel's limit on d and dv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, blk_q: int,
           blk_k: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k must be (B={B}, Hkv, Skv, d={d}) and v "
                         f"(B, Hkv, Skv, dv), got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    blk_q, blk_k = min(blk_q, Sq), min(blk_k, Skv)
    if blk_q <= 0 or blk_k <= 0 or Sq % blk_q or Skv % blk_k:
        raise ValueError(f"Sq={Sq} and Skv={Skv} must be multiples of "
                         f"blk_q={blk_q} and blk_k={blk_k} (pad upstream)")
    _build.check_operands((q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, blk_q: int = 128, blk_k: int = 128,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k: (B, Hkv, Skv, d); v: (B, Hkv, Skv, dv)
    -> (B, Hq, Sq, dv) in q.dtype.  After ``blk = min(blk, S)``,
    Sq % blk_q == 0 and Skv % blk_k == 0 (the reference's precondition;
    the CUDA kernel tiles on its own).  Scale ``d ** -0.5`` unless given.
    CUDA tensors must be contiguous float32 or bfloat16 with d, dv <= 256.
    Forward only: raises where autograd would differentiate the result
    (``flash_attention_trainable`` is the differentiable form).
    """
    _check(q, k, v, blk_q, blk_k)
    _build.refuse_grad("flash_attention", (q, k, v),
                       "call flash_attention_trainable")
    B, Hq, Sq, d = q.shape
    _, Hkv, Skv, dv = v.shape
    scale = (d ** -0.5) if scale is None else scale
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, scale=scale)
    code = _build.cuda_dtype_code((q, k, v))
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"CUDA kernel takes d, dv <= {MAX_HEAD_DIM}, "
                         f"got d={d}, dv={dv}")
    o = torch.empty((B, Hq, Sq, dv), dtype=q.dtype, device=q.device)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        lib.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   B, Hq, Hkv, Sq, Skv, d, dv, int(causal), float(scale),
                   code, _build.stream(q))
    launches.add()
    return o


class _FlashTrainable(torch.autograd.Function):
    """The kernel forward; the backward recomputes attention through plain
    ``ref.mha`` (the reference's ``_trainable`` bwd: no (S, S) tensor is
    kept from the forward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.mha(*leaves, causal=ctx.causal, scale=ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, leaves, do)
        return dq, dk, dv, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              scale: float | None = None) -> torch.Tensor:
    """Differentiable flash attention: kernel forward, recompute
    backward."""
    return _FlashTrainable.apply(q, k, v, causal, scale)


def flash_hbm_bytes(B, Hq, Hkv, Sq, Skv, d, bytes_el=2, blk_q=512) -> int:
    """The reference's analytic HBM traffic of its kernel: Q and O streamed
    once; K and V once per ``blk_q`` query rows."""
    q_o = 2 * B * Hq * Sq * d * bytes_el
    n_qblk = max(Sq // blk_q, 1)
    kv = 2 * B * Hkv * Skv * d * bytes_el * n_qblk
    return q_o + kv


def flash_flops(B, Hq, Sq, Skv, d, causal=True) -> float:
    """2 matmuls of S_q x S_kv x d per head; causal halves the live
    blocks."""
    f = 2.0 * 2.0 * B * Hq * Sq * Skv * d
    return f / 2 if causal else f
