"""Chunked-parallel RWKV-6 linear recurrence (Finch, arXiv:2404.05892).

Counterpart of ``repro/kernels/rwkv6_chunked.py``.  The sequential
recurrence
    S_t = diag(w_t) S_{t-1} + k_t^T v_t ;   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
evaluated chunk by chunk, with in-chunk cumulative log-decay
c_t = sum_{s<=t} log w_s:
    intra:  o_t += sum_{j<t} (r_t e^{c_{t-1}-c_j}) . k_j  v_j  +  (r_t.(u*k_t)) v_t
    inter:  o_t += (r_t e^{c_{t-1}}) S_prev
    carry:  S'   = e^{c_C} (x)_k S_prev + sum_j e^{c_C - c_j} k_j v_j^T

Two implementations, as in the reference:
  * ``rwkv6_chunked``        -- plain torch, the reference's formula (its
    ``"xla"`` core).  It forms the intra term as (r e^{c_{t-1}}) . (k e^{-c_j}),
    so it overflows float32 once |c| passes ~88 within a chunk: at the
    model's decay floor (log w = -1.5) at chunk > 32 or so, as the
    reference does (ROADMAP section 3 fault 7).
  * ``rwkv6_chunked_kernel`` -- the counterpart of the Pallas kernel
    ``rwkv6_chunked_pallas``: forward only, from a zero state.  On CUDA
    tensors it launches the hand kernel in ``csrc/rwkv6_chunked.cu``
    (design and bound in its header), which runs 16-step chunks with a
    float64 state on the tensor cores and forms the intra-chunk decays at
    the chunk start only where no factor can overflow (else from log2 sums,
    each factor <= 1), so it is exact at any chunk length; on CPU tensors it
    runs the plain version ``ref.rwkv6_linear_attention``.  There is no
    fallback between the two: a CUDA input launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

plain = ref.rwkv6_linear_attention
launches = _build.LaunchCount()
MAX_HEAD_DIM = 64       # the CUDA kernel's limit on dh
KERNEL_CHUNK = 16       # the CUDA kernel's steps per chunk (kL in its source)


def _chunk_math(r, k, v, lw, u, S):
    """One chunk for all (B, H). r/k/v/lw: (B,H,C,dh) fp32; S: (B,H,dh,dh)."""
    C = r.shape[2]
    c_inc = torch.cumsum(lw, dim=2)                     # c_t (inclusive)
    c_exc = c_inc - lw                                  # c_{t-1} (exclusive)
    r_dec = r * torch.exp(c_exc)                        # r_t e^{c_{t-1}}
    k_dec = k * torch.exp(c_inc[:, :, -1:, :] - c_inc)  # k_j e^{c_C - c_j}
    # intra-chunk: A[t, j] = (r_t e^{c_{t-1}}) . (k_j e^{-c_j}), j < t (the
    # reference's factorization: exact while e^{-c_j} stays finite)
    A = torch.einsum("bhtd,bhjd->bhtj", r_dec, k * torch.exp(-c_inc))
    mask = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    A = torch.where(mask, A, 0.0)
    diag = torch.einsum("bhtd,bhtd->bht", r, u[None, :, None, :] * k)
    o = torch.einsum("bhtj,bhjd->bhtd", A, v)
    o = o + diag[..., None] * v
    o = o + torch.einsum("bhtd,bhde->bhte", r_dec, S)
    S_new = (torch.exp(c_inc[:, :, -1, :])[..., None] * S
             + torch.einsum("bhjd,bhje->bhde", k_dec, v))
    return o, S_new


def rwkv6_chunked(r, k, v, w, u, *, chunk: int = 32, state=None):
    """Plain-torch chunked evaluation.  r,k,v,w: (B,H,T,dh); u: (H,dh);
    T % chunk == 0.  Returns (o: (B,H,T,dh) in r.dtype, S: (B,H,dh,dh)
    fp32)."""
    B, H, T, dh = r.shape
    if chunk <= 0 or T % chunk:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    rf, kf, vf = (a.float() for a in (r, k, v))
    lw = torch.log(torch.clamp(w.float(), min=1e-38))
    uf = u.float()
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    outs = []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        o, S = _chunk_math(rf[:, :, sl], kf[:, :, sl], vf[:, :, sl],
                           lw[:, :, sl], uf, S)
        outs.append(o)
    o = (torch.cat(outs, dim=2) if outs
         else rf.new_zeros((B, H, 0, dh)))
    return o.to(r.dtype), S


def _check(r, k, v, w, u, chunk: int) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, H, T, dh), got {tuple(r.shape)}")
    B, H, T, dh = r.shape
    for name, a in (("k", k), ("v", v), ("w", w)):
        if a.shape != r.shape:
            raise ValueError(f"{name} must be {tuple(r.shape)} like r, got "
                             f"{tuple(a.shape)}")
    if tuple(u.shape) != (H, dh):
        raise ValueError(f"u must be (H={H}, dh={dh}), got {tuple(u.shape)}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"T={T} must be a multiple of chunk={chunk}")
    ts = (r, k, v, w, u)
    if any(t.device != r.device for t in ts):
        raise ValueError("operands must lie on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")


def rwkv6_chunked_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, *,
                         chunk: int = 32) -> torch.Tensor:
    """Forward-only evaluation from a zero state, the counterpart of the
    reference's ``rwkv6_chunked_pallas``: r, k, v (B, H, T, dh) in the
    model dtype, w (B, H, T, dh) and u (H, dh) -> o (B, H, T, dh) in
    r.dtype.  T % chunk == 0 (the reference's precondition; the result
    does not depend on ``chunk``, and the CUDA kernel runs its own).
    CUDA tensors must be contiguous, r, k, v float32 or bfloat16, w and u
    float32, dh <= 64.  Raises where autograd would differentiate the
    result (the reference's kernel has no VJP either)."""
    _check(r, k, v, w, u, chunk)
    _build.refuse_grad("rwkv6_chunked_kernel", (r, k, v, w, u),
                       "differentiate the plain chunked form "
                       "(rwkv6_chunked, the model's \"xla\" core)")
    if r.device.type == "cpu":
        return plain(r, k, v, w, u)
    code = _build.cuda_dtype_code((r, k, v))
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"CUDA kernel takes float32 w and u, got {w.dtype} "
                         f"and {u.dtype}")
    if not (w.is_contiguous() and u.is_contiguous()):
        raise ValueError("CUDA kernel takes contiguous tensors")
    B, H, T, dh = r.shape
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"CUDA kernel takes dh <= {MAX_HEAD_DIM}, got {dh}")
    o = torch.empty_like(r)
    lib = _build.library("rwkv6_chunked")
    with torch.cuda.device(r.device):
        lib.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), o.data_ptr(), B, H, T, dh, code,
                   _build.stream(r))
    launches.add()
    return o


def rwkv6_hbm_bytes(B, H, T, dh, bytes_el: int = 4) -> int:
    """Streaming floor of the Pallas kernel: r/k/v/w in + o out, once."""
    return 5 * B * H * T * dh * bytes_el


def rwkv6_flops(B, H, T, dh, chunk: int = 32) -> float:
    """Per chunk: two (C,C)x(C,dh)-class matmuls + two (C,dh)x(dh,dh) state
    ops => 2*C^2*dh + 4*C*dh^2 flops; T/C chunks."""
    per_chunk = 2.0 * chunk * chunk * dh + 4.0 * chunk * dh * dh
    return B * H * (T // chunk) * per_chunk
