"""Full-batch GCN inference and training on top of AdaptGear aggregation.

Counterpart of ``repro/core/gnn.py``: ``prepare`` -> ``init_model`` ->
``select_plan`` -> ``forward``, and ``train`` (masked NLL, gradients
through the kernels' backward passes, the reference's hand-written Adam).
Ported so far: the GCN model and the ``fixed`` selector, with the paper's
default plan ``("block_diag", "bell")`` or its fused twin
``("block_diag_fused", "bell_fused")``.  Other models, selectors, bucket
autotuning and mini-batch sampling raise ``NotImplementedError`` naming the
ROADMAP slice that brings them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import adaptgear, decompose as dec_mod
from repro_torch.core.plan import KernelPlan
from repro_torch.graphs import graph as graph_mod


@dataclass
class GNNConfig:
    """The fields of the reference's GNNConfig that this slice reads.
    ``selector`` defaults to ``fixed``, the only selector ported so far
    (the reference defaults to ``feedback``)."""
    model: str = "gcn"
    hidden: int = 16
    n_layers: int = 2
    comm_size: int = 16
    reorder: str = "bfs"
    inter_buckets: int = 1        # density tiers
    lr: float = 1e-2
    selector: str = "fixed"
    fixed_kernels: tuple = ("block_diag", "bell")
    seed: int = 0
    sampler: str = "full"         # only full-batch training is ported


def _require_gcn(cfg: GNNConfig) -> None:
    if cfg.model != "gcn":
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet (only 'gcn'): "
            "ROADMAP slice B item 9")


def prepare(graph: graph_mod.Graph, cfg: GNNConfig,
            device: str | torch.device = DEFAULT_DEVICE
            ) -> dec_mod.Decomposed:
    """Preprocessing (paper §3.3/§4.2): self-loops, the symmetric GCN norm
    baked into the edge values, reorder and decomposition, with every
    registered candidate payload placed on ``device``."""
    _require_gcn(cfg)
    if cfg.inter_buckets == 0:
        raise NotImplementedError(
            "inter_buckets=0 (bucket autotuning) is not ported yet: "
            "ROADMAP slice B item 9")
    dev = resolve_device(device)
    g = graph_mod.add_self_loops(graph)
    vals = graph_mod.gcn_norm_values(g.n, g.senders, g.receivers)
    return dec_mod.decompose(g, comm_size=cfg.comm_size, method=cfg.reorder,
                             edge_vals=vals, inter_buckets=cfg.inter_buckets,
                             device=dev)


def init_model(generator: torch.Generator, cfg: GNNConfig, in_dim: int,
               n_classes: int,
               device: str | torch.device = DEFAULT_DEVICE) -> list[dict]:
    """GCN parameters, one ``dict(w, b)`` per layer, drawn from the CPU
    ``generator``.  The numbers differ from the reference's
    ``jax.random`` ones; ``repro_torch.weights.from_jax_params`` carries
    the reference's parameters over instead."""
    _require_gcn(cfg)
    dev = resolve_device(device)
    dims = [in_dim] + [cfg.hidden] * (cfg.n_layers - 1) + [n_classes]
    return [adaptgear.init_gcn_conv(generator, dims[i], dims[i + 1], dev)
            for i in range(cfg.n_layers)]


def _as_plan(dec: dec_mod.Decomposed, kernels, n_layers: int) -> KernelPlan:
    if isinstance(kernels, KernelPlan):
        if kernels.n_layers != n_layers:
            raise ValueError(f"plan has {kernels.n_layers} layers, "
                             f"model has {n_layers}")
        return kernels
    return KernelPlan.make(dec, kernels, n_layers=n_layers)


def forward(params: list[dict], cfg: GNNConfig, dec: dec_mod.Decomposed,
            x: torch.Tensor, kernels, *, acc: bool = False) -> torch.Tensor:
    """Model forward over a decomposition from :func:`prepare`.

    ``x`` is in reordered space, (n_pad, F) (``adaptgear.to_reordered``).
    ``acc=True`` threads one output buffer through each layer's subgraph
    list (the kernels' ``y_in`` variants)."""
    _require_gcn(cfg)
    plan = _as_plan(dec, kernels, len(params))
    h = x
    for i, layer in enumerate(params):
        h = adaptgear.gcn_conv(layer, dec, h, plan.for_layer(i), acc=acc)
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def select_plan(dec: dec_mod.Decomposed, cfg: GNNConfig,
                widths: list) -> tuple[KernelPlan, dict]:
    """Commit a KernelPlan with the configured selector; returns
    ``(plan, probe_times)``.  Only ``fixed`` is ported: it applies
    ``cfg.fixed_kernels`` to every layer and probes nothing."""
    if cfg.selector != "fixed":
        raise NotImplementedError(
            f"selector {cfg.selector!r} is not ported yet (only 'fixed'): "
            "ROADMAP slice A item 6")
    plan = KernelPlan.make(dec, tuple(cfg.fixed_kernels),
                           n_layers=len(widths))
    return plan, {}


def node_targets(graph: graph_mod.Graph, dec: dec_mod.Decomposed
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Labels (int64) and the mask of real nodes in reordered space, both
    (n_pad,) on ``dec``'s device, built as the reference's ``train`` does."""
    perm = dec.perm.cpu().numpy()
    labels_r = np.zeros((dec.n_pad,), np.int64)
    labels_r[perm] = graph.labels
    node_mask = np.zeros((dec.n_pad,), bool)
    node_mask[perm] = True
    return (torch.from_numpy(labels_r).to(dec.device),
            torch.from_numpy(node_mask).to(dec.device))


def _loss(params, cfg, dec, x, labels, node_mask, plan) -> torch.Tensor:
    """Mean negative log-likelihood over the real (masked) nodes."""
    logits = forward(params, cfg, dec, x, plan)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    nll = torch.where(node_mask, nll, torch.zeros_like(nll))
    return nll.sum() / node_mask.sum().clamp(min=1)


def make_train_step(cfg: GNNConfig, dec: dec_mod.Decomposed, kernels):
    """Full-graph step with Adam over a fixed KernelPlan: ``step(params,
    opt, x, labels, node_mask) -> (params, opt, loss)``.  It never writes
    into the parameters or moments it is given; the loss is that of the
    parameters passed in, as in the reference."""
    plan = _as_plan(dec, kernels, cfg.n_layers)

    def step(params, opt, x, labels, node_mask):
        leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
                  for layer in params]
        loss = _loss(leaves, cfg, dec, x, labels, node_mask, plan)
        flat = [v for layer in leaves for v in layer.values()]
        flat_g = torch.autograd.grad(loss, flat)
        it = iter(flat_g)
        grads = [{k: next(it) for k in layer} for layer in leaves]
        new_params, new_opt = _adam_update(params, grads, opt, cfg.lr)
        return new_params, new_opt, loss.detach()

    return step


def _adam_init(params: list[dict]) -> dict:
    zeros = lambda: [{k: torch.zeros_like(v) for k, v in layer.items()}  # noqa: E731
                     for layer in params]
    return dict(m=zeros(), v=zeros(), t=0)


def _adam_update(params, grads, opt, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The reference's hand-written Adam (``repro/core/gnn.py`` _adam_update),
    not ``torch.optim.Adam``: the bias corrections are taken in float32, as
    there.  Returns new tensors and leaves its inputs as they were."""
    t = opt["t"] + 1
    m = [{k: b1 * mo[k] + (1 - b1) * g for k, g in gl.items()}
         for mo, gl in zip(opt["m"], grads)]
    v = [{k: b2 * vo[k] + (1 - b2) * g * g for k, g in gl.items()}
         for vo, gl in zip(opt["v"], grads)]
    tf = np.float32(t)
    c1 = float(np.float32(1) - np.float32(b1) ** tf)
    c2 = float(np.float32(1) - np.float32(b2) ** tf)
    new = [{k: p - lr * (ml[k] / c1) / (torch.sqrt(vl[k] / c2) + eps)
            for k, p in pl.items()}
           for pl, ml, vl in zip(params, m, v)]
    return new, dict(m=m, v=v, t=t)


@dataclass
class TrainResult:
    losses: list
    accuracy: float
    kernels: list          # per-layer tuples (KernelPlan rows)
    probe_times: dict
    step_seconds: float
    preprocess_seconds: float
    plan: Any = None       # the full KernelPlan


def train(graph: graph_mod.Graph, cfg: GNNConfig, steps: int = 50,
          verbose: bool = False, *,
          device: str | torch.device = DEFAULT_DEVICE,
          params: list[dict] | None = None) -> TrainResult:
    """Full-batch training (the full-batch branch of the reference's
    ``train``) on ``device``.

    ``params`` are the initial parameters (e.g. the reference's, through
    ``repro_torch.weights.from_jax_params``); they are copied to ``device``
    and never written into.  With None they are drawn by
    :func:`init_model` from ``cfg.seed`` (torch's numbers, not
    ``jax.random``'s)."""
    if cfg.sampler != "full":
        raise NotImplementedError(
            f"sampler {cfg.sampler!r} (mini-batch training) is not ported "
            "yet: ROADMAP slice C")
    if cfg.selector != "fixed":
        raise NotImplementedError(
            f"selector {cfg.selector!r} is not ported yet (only 'fixed'): "
            "ROADMAP slice A item 6")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    dec = prepare(graph, cfg, dev)
    t_pre = time.perf_counter() - t0

    x = adaptgear.to_reordered(dec, torch.from_numpy(graph.features).to(dev))
    labels_r, node_mask = node_targets(graph, dec)

    in_dim, n_classes = x.shape[-1], graph.n_classes
    if params is None:
        params = init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            in_dim, n_classes, dev)
    else:
        params = [{k: v.detach().to(dev, torch.float32).clone()
                   for k, v in layer.items()} for layer in params]
    opt = _adam_init(params)

    dims = [in_dim] + [cfg.hidden] * (cfg.n_layers - 1) + [n_classes]
    plan, probe_times = select_plan(dec, cfg, list(zip(dims[:-1], dims[1:])))
    step_fn = make_train_step(cfg, dec, plan)

    losses = []
    t_step0 = None
    for i in range(steps):
        if i == 1:
            t_step0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, x, labels_r, node_mask)
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} plan={plan.layers}")
    step_s = ((time.perf_counter() - t_step0) / max(steps - 1, 1)
              if t_step0 else 0.0)

    with torch.no_grad():
        pred = forward(params, cfg, dec, x, plan).argmax(-1)
    acc = float(((pred == labels_r) & node_mask).sum() / node_mask.sum())
    return TrainResult(losses=losses, accuracy=acc,
                       kernels=[tuple(k) for k in plan.layers],
                       probe_times=probe_times, step_seconds=step_s,
                       preprocess_seconds=t_pre, plan=plan)
