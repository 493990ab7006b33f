"""AdaptGear aggregation dispatch + the GCN, GIN, SAGE and GAT
convolutions (paper §3/§4) and the mean and max aggregators (§2.1).

Counterpart of ``repro/core/adaptgear.py``, with the O1 baseline of the
paper's ablation (``aggregate_full_static``).
``aggregate`` computes Y = sum_s A_s @ X over the decomposition's
subgraphs with one registry kernel per subgraph.  With ``acc=True`` one
output buffer is threaded through the subgraph list (the kernels' ``y_in``
variants), and SAGE's self term rides the diagonal tier's dual-weight
kernel where the plan committed ``block_diag_fused``; with ``acc=False``
each subgraph's partial is added explicitly and the self term is one
dense product.  Both give the same sums up to float32 ordering.

``acc=None`` resolves by device, as the reference resolves it by backend
(on where its kernels run, the TPU; off on its CPU): on for CUDA tensors,
where this port's kernels run, off for CPU ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import plan as plan_mod
from repro_torch.core.decompose import Decomposed, Subgraph
from repro_torch.kernels.registry import REGISTRY

DEFAULT_KERNELS = ("block_diag", "bell")


def to_reordered(dec: Decomposed, x: torch.Tensor) -> torch.Tensor:
    """Permute node features into community order and pad to n_pad rows."""
    xr = x.index_select(0, dec.inv_perm)
    pad = dec.n_pad - dec.n
    if pad:
        xr = torch.nn.functional.pad(xr, (0, 0, 0, pad))
    return xr


def from_reordered(dec: Decomposed, xr: torch.Tensor) -> torch.Tensor:
    return xr[: dec.n].index_select(0, dec.perm)


def aggregate_sub(sub: Subgraph, x: torch.Tensor,
                  kernel: str) -> torch.Tensor:
    """A_s @ x over one subgraph with an unfused registry kernel (the unit
    the feedback probe times).  x: (n_pad, F) in reordered space."""
    spec = REGISTRY.get(kernel)
    if spec.fused:
        raise ValueError(
            f"kernel {kernel!r} is fused (needs the weight operand); "
            "dispatch it through aggregate_sub_fused / aggregate_transform")
    return spec.matvec(sub.formats[spec.payload_key], x)


def aggregate_sub_fused(sub: Subgraph, x: torch.Tensor, w: torch.Tensor,
                        kernel: str) -> torch.Tensor:
    """A_s @ (x @ w) over one subgraph with a fused registry kernel."""
    spec = REGISTRY.get(kernel)
    if not spec.fused:
        raise ValueError(f"kernel {kernel!r} is not fused")
    return spec.fused_matvec(sub.formats[spec.payload_key], x, w)


def _resolve_acc(acc: bool | None, x: torch.Tensor) -> bool:
    """``acc=None`` is on for CUDA tensors and off for CPU ones."""
    return x.device.type == "cuda" if acc is None else acc


def aggregate(dec: Decomposed, x: torch.Tensor,
              kernels: Sequence[str] = DEFAULT_KERNELS, *,
              acc: bool | None = None) -> torch.Tensor:
    """Y = A @ X via per-subgraph kernels (x reordered, (n_pad, F)).
    Fused kernels need a weight: see :func:`aggregate_transform`."""
    acc = _resolve_acc(acc, x)
    names = plan_mod.normalize_layer(dec, kernels)
    y = None
    for sub, k in zip(dec.subgraphs, names):
        spec = REGISTRY.get(k)
        if spec.fused:
            raise ValueError(f"fused kernel {k!r} needs a weight; use "
                             "aggregate_transform")
        payload = sub.formats[spec.payload_key]
        if y is None:
            y = spec.matvec(payload, x)
        elif acc and spec.matvec_acc is not None:
            y = spec.matvec_acc(payload, x, y)
        else:
            y = y + spec.matvec(payload, x)
    return y


def aggregate_transform(dec: Decomposed, x: torch.Tensor, w: torch.Tensor,
                        kernels: Sequence[str] = DEFAULT_KERNELS,
                        bias: torch.Tensor | None = None, *,
                        seed: torch.Tensor | None = None,
                        h: torch.Tensor | None = None,
                        acc: bool | None = None) -> torch.Tensor:
    """Y = A @ (X W) (+ bias / + seed), transform first, with per-subgraph
    fused or unfused kernels.

    Fused kernels take the raw features and the weight (H = X W never
    reaches device memory).  H is one dense ``torch.matmul`` (the reference
    leaves it to XLA, outside any Pallas kernel), formed once and only if
    some subgraph picked an unfused kernel, unless ``h`` supplies it.  The
    bias, or a full (n, Fo) ``seed`` (an epilogue's self term), seeds the
    threaded accumulator."""
    acc = _resolve_acc(acc, x)
    names = plan_mod.normalize_layer(dec, kernels)
    specs = [REGISTRY.get(k) for k in names]
    if h is None:
        h = x @ w if any(not s.fused for s in specs) else None
    y = None
    if seed is not None:
        if bias is not None:
            raise ValueError("pass either bias or seed, not both")
        y = seed.to(x.dtype)
    elif bias is not None:
        y = bias.to(x.dtype).expand(x.shape[0], w.shape[-1])
    for sub, spec in zip(dec.subgraphs, specs):
        payload = sub.formats[spec.payload_key]
        if spec.fused:
            if y is None:
                y = spec.fused_matvec(payload, x, w)
            elif acc and spec.fused_matvec_acc is not None:
                y = spec.fused_matvec_acc(payload, x, w, y)
            else:
                y = y + spec.fused_matvec(payload, x, w)
        elif y is None:
            y = spec.matvec(payload, h)
        elif acc and spec.matvec_acc is not None:
            y = spec.matvec_acc(payload, h, y)
        else:
            y = y + spec.matvec(payload, h)
    return y


def aggregate_transform_dual(dec: Decomposed, x: torch.Tensor,
                             w: torch.Tensor, w_self: torch.Tensor,
                             kernels: Sequence[str] = DEFAULT_KERNELS,
                             bias: torch.Tensor | None = None, *,
                             acc: bool | None = None) -> torch.Tensor:
    """Y = X W_self + A @ (X W) (+ bias): the dual-weight (SAGE) epilogue.

    The mean normalization is baked into the decomposition's edge values
    (``core.gnn.prepare``), so ``A @ (X W)`` is the normalized neighbour
    term.  With ``acc`` on and ``block_diag_fused`` committed on the first
    tier, its ``fused_dual_matvec`` hook computes that tier's term and the
    self term in one kernel from one on-chip copy of X's rows, and seeds
    the rest of the accumulation; otherwise the self term is one dense
    product that seeds it."""
    acc = _resolve_acc(acc, x)
    names = plan_mod.normalize_layer(dec, kernels)
    first = REGISTRY.get(names[0])
    if acc and first.fused_dual_matvec is not None:
        payload = dec.subgraphs[0].formats[first.payload_key]
        if bias is not None and first.fused_dual_matvec_acc is not None:
            y0 = bias.to(x.dtype).expand(x.shape[0], w.shape[-1])
            seed = first.fused_dual_matvec_acc(payload, x, w, w_self, y0)
        else:
            seed = first.fused_dual_matvec(payload, x, w, w_self)
            if bias is not None:
                seed = seed + bias.to(x.dtype)
        rest, rest_names = dec.subgraphs[1:], names[1:]
    else:
        seed = x @ w_self
        if bias is not None:
            seed = seed + bias.to(x.dtype)
        rest, rest_names = dec.subgraphs, names
    sub_dec = dataclasses.replace(dec, subgraphs=tuple(rest), stats=None)
    return aggregate_transform(sub_dec, x, w, rest_names, seed=seed, acc=acc)


def aggregate_full_static(dec: Decomposed, x: torch.Tensor,
                          kernel: str = "ell", *,
                          acc: bool | None = None) -> torch.Tensor:
    """Baseline O1 (paper §6.2): one static full-graph kernel, the same
    format on every subgraph (GNNAdvisor/NeuGraph style).  The plan layer
    rejects a kernel that does not apply to every tier before anything
    runs."""
    return aggregate(dec, x, (kernel,) * len(dec.subgraphs), acc=acc)


# ---------------------------------------------------------------------------
# Convolution layers
# ---------------------------------------------------------------------------

def _glorot(generator: torch.Generator, shape: tuple) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * lim) - lim


def init_gcn_conv(generator: torch.Generator, in_dim: int, out_dim: int,
                  device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """GCN layer parameters: glorot-uniform ``w`` (in_dim, out_dim) drawn
    from ``generator`` (a CPU generator, so every device gets the same
    numbers) and zero ``b`` (out_dim,)."""
    dev = resolve_device(device)
    return dict(w=_glorot(generator, (in_dim, out_dim)).to(dev),
                b=torch.zeros((out_dim,), dtype=torch.float32, device=dev))


def gcn_conv(params: dict, dec: Decomposed, x: torch.Tensor,
             kernels: Sequence[str], *,
             acc: bool | None = None) -> torch.Tensor:
    """GCN layer: Y = Â (X W) + b (Kipf & Welling; Â's norm is baked into
    the decomposition's edge values)."""
    return aggregate_transform(dec, x, params["w"], kernels,
                               bias=params["b"], acc=acc)


def init_gin_conv(generator: torch.Generator, in_dim: int, hidden: int,
                  out_dim: int,
                  device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """GIN layer parameters: ``eps`` () at 0, glorot-uniform ``w1`` (in_dim,
    hidden) then ``w2`` (hidden, out_dim) drawn in that order from the CPU
    ``generator``, and zero ``b1`` (hidden,) and ``b2`` (out_dim,)."""
    dev = resolve_device(device)
    w1 = _glorot(generator, (in_dim, hidden))
    w2 = _glorot(generator, (hidden, out_dim))
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(eps=torch.zeros((), **f32), w1=w1.to(dev),
                b1=torch.zeros((hidden,), **f32), w2=w2.to(dev),
                b2=torch.zeros((out_dim,), **f32))


def gin_conv(params: dict, dec: Decomposed, x: torch.Tensor,
             kernels: Sequence[str], structure: str = "transform_first", *,
             acc: bool | None = None) -> torch.Tensor:
    """GIN layer: MLP((1+eps) x + sum-agg(x)) (Xu et al.), under the
    structure the selector priced (``EpilogueSpec.structure``).

    transform-first: W1 pushes through the aggregation,

        h1 = relu((1+eps) S + A (X W1) + b1),   S = X W1
        y  = h1 W2 + b2

    the self term ``(1+eps) S + b1`` seeds the threaded accumulator, and
    ``S`` is the unfused kernels' transform too (computed once).
    aggregate-first, where the raw input is narrower than the hidden
    width: z = (1+eps) X + A X, y = relu(z W1 + b1) W2 + b2.  A plan that
    commits a fused kernel on some tier runs transform-first whatever
    ``structure`` says (A (X W1) is the only pass a fused kernel does),
    as in the reference.  The dense products are ``torch.matmul``."""
    if structure == "aggregate_first":
        names = plan_mod.normalize_layer(dec, kernels)
        if not any(REGISTRY.get(k).fused for k in names):
            z = (1.0 + params["eps"]) * x + aggregate(dec, x, names, acc=acc)
            h1 = torch.relu(z @ params["w1"] + params["b1"])
            return h1 @ params["w2"] + params["b2"]
    s = x @ params["w1"]
    seed = (1.0 + params["eps"]) * s + params["b1"]
    h1 = torch.relu(aggregate_transform(dec, x, params["w1"], kernels,
                                        seed=seed, h=s, acc=acc))
    return h1 @ params["w2"] + params["b2"]


def init_sage_conv(generator: torch.Generator, in_dim: int, out_dim: int,
                   device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """SAGE layer parameters: glorot-uniform ``w_self`` then ``w_neigh``
    (in_dim, out_dim), drawn in that order from the CPU ``generator``, and
    zero ``b`` (out_dim,)."""
    dev = resolve_device(device)
    w_self = _glorot(generator, (in_dim, out_dim))
    w_neigh = _glorot(generator, (in_dim, out_dim))
    return dict(w_self=w_self.to(dev), w_neigh=w_neigh.to(dev),
                b=torch.zeros((out_dim,), dtype=torch.float32, device=dev))


def sage_conv(params: dict, dec: Decomposed, x: torch.Tensor,
              kernels: Sequence[str],
              inv_deg: torch.Tensor | None = None, *,
              acc: bool | None = None) -> torch.Tensor:
    """GraphSAGE mean aggregator: W_self x + W_neigh mean_agg(x) + b.

    With ``inv_deg=None`` the decomposition's edge values carry the mean
    normalization (``core.gnn.prepare``), W_neigh pushes through the
    aggregation and the layer is :func:`aggregate_transform_dual`.  With
    ``inv_deg`` (n_pad,) it is the unbaked form for unnormalized edge
    values: aggregate x, rescale each row, transform after."""
    if inv_deg is not None:
        agg = aggregate(dec, x, kernels, acc=acc) * inv_deg[:, None]
        return x @ params["w_self"] + agg @ params["w_neigh"] + params["b"]
    return aggregate_transform_dual(dec, x, params["w_neigh"],
                                    params["w_self"], kernels,
                                    bias=params["b"], acc=acc)


def init_gat_conv(generator: torch.Generator, in_dim: int, out_dim: int,
                  device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Single-head GAT layer parameters: glorot-uniform ``w`` (in_dim,
    out_dim), then ``a_dst`` and ``a_src`` (out_dim,) (each the column of
    an (out_dim, 1) glorot draw), drawn in that order from the CPU
    ``generator``, and zero ``b`` (out_dim,)."""
    dev = resolve_device(device)
    w = _glorot(generator, (in_dim, out_dim))
    a_dst = _glorot(generator, (out_dim, 1))[:, 0]
    a_src = _glorot(generator, (out_dim, 1))[:, 0]
    return dict(w=w.to(dev), a_dst=a_dst.to(dev), a_src=a_src.to(dev),
                b=torch.zeros((out_dim,), dtype=torch.float32, device=dev))


def _segment_max(vals: torch.Tensor, rows: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """Per-row max of ``vals`` (E, ...) over the edges of each row, -inf
    where a row has none (``jax.ops.segment_max``); its gradient splits
    evenly among tied maxima, as JAX's does."""
    out = torch.full((n_rows,) + vals.shape[1:], -math.inf,
                     dtype=vals.dtype, device=vals.device)
    idx = rows.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce(0, idx, vals, "amax", include_self=True)


def _segment_sum(vals: torch.Tensor, rows: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """Per-row sum of ``vals`` (E, ...) over the edges of each row, 0 where
    a row has none (``jax.ops.segment_sum``)."""
    out = torch.zeros((n_rows,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, rows, vals)


def gat_conv(params: dict, dec: Decomposed, x: torch.Tensor,
             negative_slope: float = 0.2) -> torch.Tensor:
    """Single-head GAT (Velickovic et al.) with subgraph-level execution.

    The logits e_ij = LeakyReLU(a_dst.h_i + a_src.h_j), h = x W, are
    softmax-normalized over all in-neighbours of i across every subgraph,
    so the parts share one row max and one row sum.  The diagonal tier is
    dense masked per-block logits (mask ``blocks != 0``) and one batched
    product (``torch.bmm``); each inter bucket is a COO edge softmax
    (``scatter_reduce`` / ``index_add``).  A row with no in-neighbour
    has max -inf, taken as 0, and sum 0, clamped to 1e-9, so its output
    is ``b`` and no NaN reaches the forward or the gradients.  Like the
    reference's, it reads the decomposition's edges, not a kernel plan:
    none of this is a Pallas kernel there, so it stays torch ops here."""
    h = x @ params["w"]                                     # (n_pad, F)
    s_dst = h @ params["a_dst"]                             # (n_pad,)
    s_src = h @ params["a_src"]
    B = dec.block_size
    nb = dec.n_pad // B
    neg_inf = torch.tensor(-math.inf, dtype=h.dtype, device=h.device)
    # -- intra: dense per-block logits
    mask = dec.intra.formats["block_diag"].blocks != 0      # (nb, B, B)
    e_in = s_dst.reshape(nb, B)[:, :, None] + s_src.reshape(nb, B)[:, None, :]
    e_in = torch.where(mask, F.leaky_relu(e_in, negative_slope), neg_inf)
    # -- inter buckets: per-edge logits (each bucket's COO is row-sorted)
    edge_parts = [(rows, cols, F.leaky_relu(s_dst[rows] + s_src[cols],
                                            negative_slope))
                  for rows, cols in dec.inter_edges_i64]
    # -- joint row max across all subgraphs (-inf for a row with none)
    m = torch.amax(e_in, dim=-1).reshape(-1)
    for rows, _, e_out in edge_parts:
        m = torch.maximum(m, _segment_max(e_out, rows, dec.n_pad))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    # -- exp and joint row sum
    p_in = torch.where(mask, torch.exp(e_in - m.reshape(nb, B)[:, :, None]),
                       torch.zeros_like(e_in))
    z = p_in.sum(-1).reshape(-1)
    p_outs = []
    for rows, _, e_out in edge_parts:
        p_out = torch.exp(e_out - m[rows])
        p_outs.append(p_out)
        z = z + _segment_sum(p_out, rows, dec.n_pad)
    z = torch.clamp(z, min=1e-9)
    # -- weighted aggregation per subgraph
    y = torch.bmm(p_in, h.reshape(nb, B, -1)).reshape(dec.n_pad, -1)
    for (rows, cols, _), p_out in zip(edge_parts, p_outs):
        y = y + _segment_sum(h[cols] * p_out[:, None], rows, dec.n_pad)
    return (y / z[:, None]).to(x.dtype) + params["b"]


# ---------------------------------------------------------------------------
# Non-sum aggregation operators (paper §2.1: aggregate-mean / aggregate-max)
# ---------------------------------------------------------------------------

def aggregate_mean(dec: Decomposed, x: torch.Tensor, inv_deg: torch.Tensor,
                   kernels: Sequence[str] = DEFAULT_KERNELS, *,
                   acc: bool | None = None) -> torch.Tensor:
    """Mean over in-neighbours: :func:`aggregate` (the kernels of the plan
    given, the dense diagonal kernel among them) times ``inv_deg``
    (n_pad,) per row."""
    return aggregate(dec, x, kernels, acc=acc) * inv_deg[:, None]


# the reference's fill for masked slots (float32's lowest, rounded)
_MAX_FILL = -3.4e38


def aggregate_max(dec: Decomposed, x: torch.Tensor) -> torch.Tensor:
    """Max over in-neighbours across every subgraph; 0 for a row with
    none.  Max is not a product, so no dense-block kernel computes it: the
    diagonal tier gathers through its ELL payload (masked slots filled
    with -3.4e38), each inter bucket takes a segment max over its COO
    edges, and an elementwise max joins them, in float32 (float64 for
    float64 inputs), cast back to ``x``'s dtype.  Gradients split evenly
    among tied maxima (``torch.amax``, ``scatter_reduce`` ``"amax"``,
    ``torch.maximum``), as the reference's ``jnp.max``, ``segment_max``
    and ``jnp.maximum`` do; ``torch.max(dim=)`` would send it all to one
    index."""
    acc_t = torch.promote_types(x.dtype, torch.float32)
    neg = torch.tensor(_MAX_FILL, dtype=torch.float32,
                       device=x.device).to(acc_t)
    xa = x.to(acc_t)
    ell = dec.intra.formats["ell"]
    g_in = torch.where(ell.mask[..., None], xa[ell.indices], neg)
    m = torch.amax(g_in, dim=1)                              # (n_pad, F)
    for rows, cols in dec.inter_edges_i64:
        m = torch.maximum(m, _segment_max(xa[cols], rows, dec.n_pad))
    return torch.where(m <= neg / 2, torch.zeros_like(m), m).to(x.dtype)
