"""Plain PyTorch versions of the aggregation kernels, of attention, of the
RWKV-6 recurrence and of the selective SSM (Mamba) scan.

Counterpart of ``repro/kernels/ref.py``.
They are the correctness references the CUDA kernels are held against on
the card, and what each wrapper runs when its tensors lie on the CPU.
Products accumulate in float32 (float64 for float64 inputs, so gradients
can be checked numerically) and the result is cast back to the input
dtype, as in the reference; the dW reduction returns its accumulation
type.
"""
from __future__ import annotations

import torch


def _acc(t: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: float32, or float64 for float64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def block_diag_spmm(blocks: torch.Tensor, x: torch.Tensor,
                    y_in: torch.Tensor | None = None, *,
                    transpose: bool = False) -> torch.Tensor:
    """Y[b*B:(b+1)*B] = blocks[b] @ x[b*B:(b+1)*B] (+ y_in); with
    ``transpose`` each block's transpose instead.

    blocks: (nb, B, B); x: (nb*B, F); y_in: optional (nb*B, F)."""
    nb, B, _ = blocks.shape
    acc = _acc(x)
    a = blocks.transpose(1, 2) if transpose else blocks
    y = torch.einsum("bij,bjf->bif", a.to(acc),
                     x.reshape(nb, B, -1).to(acc)).reshape(nb * B, -1)
    if y_in is not None:
        y = y_in.to(acc) + y
    return y.to(x.dtype)


def bell_spmm(blocks: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
              y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked-ELL SpMM: Y[i] = sum_k blocks[i,k] @ X[col_idx[i,k]] (+ y_in).

    blocks: (nbr, K, B, B); col_idx: (nbr, K) block-column ids;
    x: (n_cols_pad, F) -> (nbr*B, F).  Padding blocks are all-zero, so
    their contribution vanishes whatever col_idx names."""
    nbr, K, B, _ = blocks.shape
    acc = _acc(x)
    xb = x.reshape(-1, B, x.shape[-1]).to(acc)          # (nbc, B, F)
    gathered = xb[col_idx.long()]                       # (nbr, K, B, F)
    y = torch.einsum("rkij,rkjf->rif", blocks.to(acc),
                     gathered).reshape(nbr * B, -1)
    if y_in is not None:
        y = y_in.to(acc) + y
    return y.to(x.dtype)


def block_diag_spmm_fused(blocks: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, y_in: torch.Tensor | None = None,
                          *, transpose: bool = False) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) (+ y_in); with ``transpose`` each
    block's transpose.  x: (nb*B, Fi); w: (Fi, Fo) -> (nb*B, Fo)."""
    acc = _acc(x)
    h = x.to(acc) @ w.to(acc)
    y = block_diag_spmm(blocks.to(acc), h,
                        y_in.to(acc) if y_in is not None else None,
                        transpose=transpose)
    return y.to(x.dtype)


def block_diag_spmm_dual(blocks: torch.Tensor, x: torch.Tensor,
                         w: torch.Tensor, w_self: torch.Tensor,
                         y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y = blockdiag(blocks) @ (x @ w) + x @ w_self (+ y_in): SAGE's
    dual-weight epilogue on the diagonal tier.  x: (nb*B, Fi); w, w_self:
    (Fi, Fo) -> (nb*B, Fo)."""
    acc = _acc(x)
    xa = x.to(acc)
    y = block_diag_spmm(blocks.to(acc), xa @ w.to(acc)) + xa @ w_self.to(acc)
    if y_in is not None:
        y = y_in.to(acc) + y
    return y.to(x.dtype)


def bell_spmm_fused(blocks: torch.Tensor, col_idx: torch.Tensor,
                    x: torch.Tensor, w: torch.Tensor,
                    y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A_bell @ (x @ w) (+ y_in).  x: (n_cols_pad, Fi); w: (Fi, Fo).

    The transform runs once over x, then the blocked-ELL product gathers
    the (B, Fo) slices of H: the same function as the kernel's per-block
    transform, without a (nbr, K, B, Fi) gather."""
    acc = _acc(x)
    h = x.to(acc) @ w.to(acc)
    y = bell_spmm(blocks.to(acc), col_idx, h,
                  y_in.to(acc) if y_in is not None else None)
    return y.to(x.dtype)


def bell_spmm_dw(blocks_t: torch.Tensor, col_idx_t: torch.Tensor | None,
                 x: torch.Tensor, g: torch.Tensor, *,
                 transpose: bool = False) -> torch.Tensor:
    """dW = x^T @ (A^T @ g) with A^T in blocked-ELL (the transpose payload).

    blocks_t: (nbr, K, B, B), read transposed with ``transpose``;
    col_idx_t: (nbr, K) block columns of g, or None for identity columns
    (K = 1, the diagonal tier); x: (nbr*B, Fi); g: (n_cols_pad, Fo).
    Returns (Fi, Fo) in the accumulation dtype.  A^T g is formed at width
    Fo, so nothing of width Fi is gathered."""
    acc = _acc(x)
    if col_idx_t is None:
        col_idx_t = torch.arange(blocks_t.shape[0], dtype=torch.int32,
                                 device=blocks_t.device)[:, None]
    a = blocks_t.transpose(2, 3) if transpose else blocks_t
    z = bell_spmm(a.to(acc), col_idx_t, g.to(acc))      # (nbr*B, Fo)
    return x.to(acc).T @ z


def tcgnn_spmm(tiles: torch.Tensor, gather_idx: torch.Tensor,
               x: torch.Tensor, y_in: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Column-condensed SpMM: Y[i*B + r] = sum_s tiles[i, r, s]
    x[gather_idx[i, s]] (+ y_in).

    tiles: (nbr, B, C); gather_idx: (nbr, C) source rows of x, 0 in padded
    slots (whose tile values are zero); x: (n_cols, F) -> (nbr*B, F)."""
    nbr, B, _ = tiles.shape
    acc = _acc(x)
    xg = x[gather_idx.long()].to(acc)                    # (nbr, C, F)
    y = torch.bmm(tiles.to(acc), xg).reshape(nbr * B, -1)
    if y_in is not None:
        y = y_in.to(acc) + y
    return y.to(x.dtype)


def tcgnn_spmm_fused(tiles: torch.Tensor, gather_idx: torch.Tensor,
                     x: torch.Tensor, w: torch.Tensor,
                     y_in: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A_tc @ (x @ w) (+ y_in).  The transform runs once over x and the
    condensed product gathers rows of H: the same function as the kernel's
    per-slot transform, without the (nbr, C, Fi) gather."""
    acc = _acc(x)
    h = x.to(acc) @ w.to(acc)
    y = tcgnn_spmm(tiles.to(acc), gather_idx, h,
                   y_in.to(acc) if y_in is not None else None)
    return y.to(x.dtype)


def tcgnn_spmm_dw(tiles_t: torch.Tensor, gather_idx_t: torch.Tensor,
                  x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW = x^T @ (A^T @ g) with A^T the condensed transpose payload:
    sum_i x_i^T (tiles_t[i] @ g[gather_idx_t[i]]).  x: (nbr*B, Fi);
    g: (n_cols, Fo).  Returns (Fi, Fo) in the accumulation dtype."""
    acc = _acc(x)
    z = tcgnn_spmm(tiles_t.to(acc), gather_idx_t, g.to(acc))   # (nbr*B, Fo)
    return x.to(acc).T @ z


def ell_spmm(indices: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Row-padded gather SpMM: Y[i] = sum_k vals[i,k] * x[indices[i,k]].

    indices/vals: (n, K) (vals zero where padded); x: (n_cols, F)."""
    gathered = x[indices.long()].float()               # (n, K, F)
    return torch.einsum("nk,nkf->nf", vals.float(), gathered).to(x.dtype)


def coo_spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Edge-parallel scatter-add.  The gather is ``index_select``, whose
    backward is one ``index_add_``: an indexing gather's backward sorts
    its indices, which takes milliseconds on a spill padded to the edge
    budget (every pad slot reads row 0)."""
    msgs = x.index_select(0, cols.long()).float() * vals.float()[:, None]
    y = torch.zeros((n_rows, x.shape[-1]), dtype=torch.float32,
                    device=x.device)
    return y.index_add_(0, rows.long(), msgs).to(x.dtype)


def coo_spmm_dense_ref(rows: torch.Tensor, cols: torch.Tensor,
                       vals: torch.Tensor, x: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """O(n^2) dense-materialized oracle (small shapes only): A (n_rows,
    n_cols) with duplicate edges added, times x, in float32."""
    a = torch.zeros((n_rows, x.shape[0]), dtype=torch.float32,
                    device=x.device)
    a.index_put_((rows.long(), cols.long()), vals.float(), accumulate=True)
    return (a @ x.float()).to(x.dtype)


# --- attention -------------------------------------------------------------

NEG_INF = -1e30     # the reference's mask value (finite, as in its kernels)


def _softmax_core(q, k, v, mask, scale) -> torch.Tensor:
    """softmax(q k^T * scale, -1e30 where ``mask`` is False) v in
    float32 (float64 for float64 inputs), GQA by head groups: query head h
    reads kv head h // (Hq // Hkv).  q: (B, Hq, S, d); k: (B, Hkv, T, d);
    v: (B, Hkv, T, dv); mask: (S, T) bool or None -> (B, Hq, S, dv) in
    q.dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    acc = _acc(q)
    qf = q.to(acc).reshape(b, hkv, g, s, d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(acc)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(acc))
    return out.reshape(b, hq, s, v.shape[-1]).to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Reference multi-head attention. q: (B, Hq, S, D); k/v: (B, Hkv, T, D).
    GQA handled by head-group broadcast.  The causal mask is
    ``tril(k=T-S)``: aligned to the bottom right, so the last query sees
    every key."""
    s, t = q.shape[2], k.shape[2]
    sc = (q.shape[-1] ** -0.5) if scale is None else scale
    mask = None
    if causal:
        mask = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(diagonal=t - s)
    return _softmax_core(q, k, v, mask, sc)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """The flash kernel's function: attention whose causal mask keeps
    ``q_pos >= k_pos`` from the top left, as the reference's Pallas kernel
    masks (``repro/kernels/flash_attention.py`` ``_kernel``).  It equals
    ``mha`` when causal is off or Sq == Skv.  q: (B, Hq, Sq, d);
    k: (B, Hkv, Skv, d); v: (B, Hkv, Skv, dv) -> (B, Hq, Sq, dv)."""
    s, t = q.shape[2], k.shape[2]
    sc = (q.shape[-1] ** -0.5) if scale is None else scale
    mask = None
    if causal:
        pos = torch.arange(max(s, t), device=q.device)
        mask = pos[:s, None] >= pos[None, :t]
    return _softmax_core(q, k, v, mask, sc)


# --- RWKV-6 / gated linear recurrence ---------------------------------------

def rwkv6_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     state: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence step by step from ``state`` (zeros if None):
      o_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1}
      + k_t^T v_t
    in float32 (float64 for float64 inputs).  r, k, v, w: (B, H, T, D);
    u: (H, D); state: (B, H, D, D).  Returns (o (B, H, T, D), S_T), both
    in the accumulation dtype."""
    B, H, T, D = r.shape
    acc = _acc(r)
    rf, kf, vf, wf = (a.to(acc) for a in (r, k, v, w))
    uf = u.to(acc)
    S = (torch.zeros((B, H, D, D), dtype=acc, device=r.device)
         if state is None else state.to(acc))
    outs = []
    for t in range(T):
        rt, kt, vt = rf[:, :, t], kf[:, :, t], vf[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]              # (B,H,D,D)
        outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                 S + uf[:, :, None] * kv))
        S = wf[:, :, t, :, None] * S + kv
    o = (torch.stack(outs, dim=2) if outs
         else rf.new_zeros((B, H, 0, D)))
    return o, S


def rwkv6_linear_attention(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RWKV-6 (Finch) recurrence, sequential oracle, from a zero state.

    r, k, v: (B, H, T, D); w: (B, H, T, D) per-step decay in (0, 1);
    u: (H, D) bonus for the current token.
      S_t = diag(w_t) S_{t-1} + k_t^T v_t
      o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    Shapes follow arXiv:2404.05892 eq. (17)-(19).  Returns o in r.dtype."""
    return rwkv6_recurrence(r, k, v, w, u)[0].to(r.dtype)


# --- selective SSM (Mamba) ---------------------------------------------------

def mamba_recurrence(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective SSM step by step from a zero state:
      h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t + D x_t
    in float32 (float64 for float64 inputs).  x, dt: (B, T, d_inner), dt
    post-softplus; A: (d_inner, d_state); Bc, Cc: (B, T, d_state);
    D: (d_inner,).  Returns (y (B, T, d_inner), the final state h_T (B,
    d_inner, d_state)), both in the accumulation dtype."""
    acc = _acc(x)
    xb, dtb, Bb, Cb = (a.to(acc) for a in (x, dt, Bc, Cc))
    Af = A.to(acc)
    Bsz, T, di = x.shape
    h = torch.zeros((Bsz, di, Af.shape[-1]), dtype=acc, device=x.device)
    ys = []
    for t in range(T):
        dA = torch.exp(dtb[:, t, :, None] * Af)              # (B, di, ds)
        dBx = (dtb[:, t] * xb[:, t])[..., None] * Bb[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bds,bs->bd", h, Cb[:, t]))
    y = torch.stack(ys, dim=1) if ys else xb.new_zeros((Bsz, 0, di))
    return y + xb * D.to(acc), h


def mamba_ssm(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor,
              D: torch.Tensor) -> torch.Tensor:
    """Selective state space scan, sequential oracle, from a zero state.

    x: (B, T, d_inner); dt: (B, T, d_inner) (post-softplus);
    A: (d_inner, d_state); Bc/Cc: (B, T, d_state); D: (d_inner,)
      h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t ;  y_t = C_t . h_t + D x_t
    Returns y in x.dtype."""
    return mamba_recurrence(x, dt, A, Bc, Cc, D)[0].to(x.dtype)
