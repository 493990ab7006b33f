"""Full-batch GCN, GIN, GAT and GraphSAGE inference and training on top
of AdaptGear aggregation.

Counterpart of ``repro/core/gnn.py``: ``prepare`` (with bucket-count
autotuning at ``inter_buckets=0``) -> ``init_model`` -> ``select_plan`` ->
``forward``, and ``train`` (masked NLL, gradients through the kernels'
backward passes, the reference's hand-written Adam), for every model of
the reference with all three selectors.  GIN's per-layer structure
(transform-first or aggregate-first) is priced against the decomposition
(``layer_plan_inputs``).  ``feedback``, the default as in the reference,
times every registry candidate of every subgraph at every layer width on
the device that trains and commits the fastest (``core/selector.py``);
``cost_model`` ranks them by the analytic model of that device; ``fixed``
applies ``fixed_kernels``.  GAT reads the decomposition's edges, not the
plan (``adaptgear.gat_conv``), yet selection still commits one, as in the
reference.  ``cfg.sampler`` ``"cluster"`` or ``"neighbor"`` switches
``train`` to mini-batch training over sampled subgraphs
(``train/gnn_steps.py``), as in the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import adaptgear, decompose as dec_mod
from repro_torch.core import epilogue as ep_mod
from repro_torch.core import selector as sel_mod
from repro_torch.core.plan import KernelPlan
from repro_torch.graphs import graph as graph_mod


@dataclass
class GNNConfig:
    """The fields of the reference's GNNConfig that the port reads, with
    the reference's defaults (``selector`` is ``feedback``).  The
    mini-batch fields, the retries among them, are read by
    ``train/gnn_steps.py``."""
    model: str = "gcn"            # gcn | gin | gat | sage
    hidden: int = 16
    n_layers: int = 2
    comm_size: int = 16
    reorder: str = "bfs"          # bfs | louvain (metis -> louvain)
    inter_buckets: int = 1        # density tiers; 0 = autotune over {1,2,4}
    lr: float = 1e-2
    selector: str = "feedback"    # feedback | cost_model | fixed
    fixed_kernels: tuple = ("block_diag", "bell")
    warmup_iters: int = 2         # feedback: timed calls per candidate
    seed: int = 0
    # --- mini-batch sampling (train/gnn_steps.py; "full" = whole graph) ---
    sampler: str = "full"         # full | cluster | neighbor
    clusters_per_batch: int = 8   # cluster: batch = q community blocks
    batch_nodes: int = 128        # neighbor: loss-carrying seeds per batch
    fanouts: tuple = (8, 4)       # neighbor: per-layer in-neighbor caps
    edge_budget: int = 0          # cluster: padded edge slots (0 = auto)
    cache_entries: int = 128      # PlanCache LRU bound
    # probe-on-Nth-miss: every Nth PlanCache miss times the top-2
    # cost-model candidates on the device and pins the winner (0 = off)
    probe_every: int = 0
    probe_k_max: int = 4          # widest probe frontier
    probe_budget_s: float = 2.0   # one miss's probe wall time
    # budget-K autotuning: observed capped-payload spill steps the caps'
    # slack factor along a ladder (each step changes payload shapes)
    adapt_budget_k: bool = False
    skeleton_cache_entries: int = 64   # cluster-tuple skeleton LRU (0 = off)
    # async pipeline (train/pipeline.py): batches prepared on
    # pipeline_workers threads up to prefetch_depth ahead (0 = sync loop)
    prefetch_depth: int = 0
    pipeline_workers: int = 2
    max_ladder_recompiles: int = 4     # cap on slack-ladder steps per run
    # crash-safe checkpoints every checkpoint_every batches (the newest
    # checkpoint_keep kept), and resume from a checkpoint directory
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    resume_from: str = ""
    # bounded exponential-backoff retries of a batch's build on transient
    # failures (fault_tolerance.default_transient); 0 = off
    retry_max: int = 0
    retry_base_delay_s: float = 0.05
    # non-finite guard: a batch whose loss or any gradient is NaN/Inf
    # leaves params and the whole Adam state (t included) as they were,
    # and is counted
    nonfinite_guard: bool = True
    # observability (repro_torch.obs): span tracer + selector audit; the
    # exports are written when training ends and imply telemetry on
    telemetry: bool = False
    trace_out: str = ""           # Chrome trace path ("" = no export)
    telemetry_out: str = ""       # audit JSONL path ("" = no export)


MODELS = ("gcn", "gin", "gat", "sage")


def _require_model(cfg: GNNConfig) -> None:
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r} (one of {MODELS})")


def prepare(graph: graph_mod.Graph, cfg: GNNConfig,
            device: str | torch.device = DEFAULT_DEVICE
            ) -> dec_mod.Decomposed:
    """Preprocessing (paper §3.3/§4.2): the per-model edge normalization
    baked into the edge values (GCN: self-loops and the symmetric norm;
    SAGE: no self-loops and the mean aggregator's 1/deg(dst); GIN and GAT:
    no self-loops and unit values), reorder and decomposition, with every
    registered candidate payload placed on ``device``.
    ``cfg.inter_buckets == 0`` autotunes the bucket count
    (:func:`autotune_decomposition`)."""
    _require_model(cfg)
    dev = resolve_device(device)
    g, vals = graph, None
    if cfg.model == "gcn":
        g = graph_mod.add_self_loops(graph)
        vals = graph_mod.gcn_norm_values(g.n, g.senders, g.receivers)
    elif cfg.model == "sage":
        vals = graph_mod.mean_norm_values(g.n, g.senders, g.receivers)
    if cfg.inter_buckets == 0:
        return autotune_decomposition(
            g, cfg, vals, in_dim=graph.features.shape[-1],
            n_classes=graph.n_classes, device=dev)
    return dec_mod.decompose(g, comm_size=cfg.comm_size, method=cfg.reorder,
                             edge_vals=vals, inter_buckets=cfg.inter_buckets,
                             device=dev)


def autotune_decomposition(g: graph_mod.Graph, cfg: GNNConfig, edge_vals,
                           in_dim: int, n_classes: int,
                           ks: tuple = (1, 2, 4), *,
                           device: str | torch.device = DEFAULT_DEVICE
                           ) -> dec_mod.Decomposed:
    """Bucket-count autotuning: decompose at each inter-bucket count in
    ``ks`` on ``device``, total ``selector.plan_layer_cost`` over the
    model's layers under the device's cost model
    (``selector.default_hw``: ``H100_HW`` on CUDA, ``CPU_HW`` elsewhere),
    and return the cheapest decomposition (the first on a tie).  Layers
    are priced per k: a GIN layer's structure may flip with the tiers.
    The per-k totals land in ``dec.stats["bucket_autotune"]``."""
    dev = resolve_device(device)
    hw = sel_mod.default_hw(dev)
    best, best_total, totals = None, None, {}
    for k in ks:
        dec = dec_mod.decompose(g, comm_size=cfg.comm_size,
                                method=cfg.reorder, edge_vals=edge_vals,
                                inter_buckets=k, device=dev)
        pairs, eps = layer_plan_inputs(cfg, in_dim, n_classes, dec=dec,
                                       hw=hw)
        total = sum(sel_mod.plan_layer_cost(dec, fout, hw=hw, in_dim=fin,
                                            epilogue=ep)
                    for (fin, fout), ep in zip(pairs, eps))
        totals[k] = float(total)
        if best_total is None or total < best_total:
            best, best_total = dec, total
    best.stats["bucket_autotune"] = totals
    return best


def init_model(generator: torch.Generator, cfg: GNNConfig, in_dim: int,
               n_classes: int,
               device: str | torch.device = DEFAULT_DEVICE) -> list[dict]:
    """Model parameters, one dict per layer (GCN: ``w, b``; SAGE:
    ``w_self, w_neigh, b``; GIN: ``eps, w1, b1, w2, b2``; GAT: ``w,
    a_dst, a_src, b``), drawn in layer order from the CPU ``generator``.
    The numbers differ from the reference's ``jax.random`` ones;
    ``repro_torch.weights.from_jax_params`` carries the reference's
    parameters over instead."""
    _require_model(cfg)
    dev = resolve_device(device)
    dims = [in_dim] + [cfg.hidden] * (cfg.n_layers - 1) + [n_classes]
    if cfg.model == "gin":
        return [adaptgear.init_gin_conv(generator, dims[i], cfg.hidden,
                                        dims[i + 1], dev)
                for i in range(cfg.n_layers)]
    init = {"gcn": adaptgear.init_gcn_conv, "gat": adaptgear.init_gat_conv,
            "sage": adaptgear.init_sage_conv}[cfg.model]
    return [init(generator, dims[i], dims[i + 1], dev)
            for i in range(cfg.n_layers)]


def _as_plan(dec: dec_mod.Decomposed, kernels, n_layers: int) -> KernelPlan:
    if isinstance(kernels, KernelPlan):
        if kernels.n_layers != n_layers:
            raise ValueError(f"plan has {kernels.n_layers} layers, "
                             f"model has {n_layers}")
        return kernels
    return KernelPlan.make(dec, kernels, n_layers=n_layers)


def forward(params: list[dict], cfg: GNNConfig, dec: dec_mod.Decomposed,
            x: torch.Tensor, kernels, *,
            acc: bool | None = None) -> torch.Tensor:
    """Model forward over a decomposition from :func:`prepare`.

    ``x`` is in reordered space, (n_pad, F) (``adaptgear.to_reordered``).
    ``acc=True`` threads one output buffer through each layer's subgraph
    list (the kernels' ``y_in`` variants) and lets SAGE's self term ride
    the diagonal tier's dual-weight kernel; ``None`` turns it on for CUDA
    tensors and off for CPU ones.  A GIN layer runs the structure of the
    plan's EpilogueSpec (transform-first where the plan has none); a GAT
    layer reads the decomposition's edges, not the plan."""
    _require_model(cfg)
    plan = _as_plan(dec, kernels, len(params))
    h = x
    for i, layer in enumerate(params):
        names = plan.for_layer(i)
        if cfg.model == "gin":
            ep = plan.epilogue_for_layer(i)
            h = adaptgear.gin_conv(layer, dec, h, names,
                                   structure=(ep.structure if ep is not None
                                              else "transform_first"),
                                   acc=acc)
        elif cfg.model == "gat":
            h = adaptgear.gat_conv(layer, dec, h)
        else:
            conv = (adaptgear.gcn_conv if cfg.model == "gcn"
                    else adaptgear.sage_conv)
            h = conv(layer, dec, h, names, acc=acc)
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def agg_widths(cfg: GNNConfig, in_dim: int, n_classes: int) -> list[int]:
    """The feature width each layer's aggregation runs at."""
    return [fout for _, fout in agg_width_pairs(cfg, in_dim, n_classes)]


def agg_width_pairs(cfg: GNNConfig, in_dim: int,
                    n_classes: int) -> list[tuple]:
    """Per-layer ``(in_dim, agg_dim)`` width pairs.  GCN's and SAGE's
    layers are transform-first (SAGE through its dual epilogue), so fused
    candidates compete at every layer.  A GIN layer aggregates at the
    MLP's hidden width with W1 pushed through, ``(d, hidden)``, unless its
    raw input is narrower than the hidden width: then it aggregates the
    raw features, ``(None, d)``, and fused candidates sit out (the
    decomposition-free rule; ``layer_plan_inputs`` prices it).  GAT
    aggregates raw inputs: ``(None, d)`` at every layer."""
    _require_model(cfg)
    dims = [in_dim] + [cfg.hidden] * (cfg.n_layers - 1) + [n_classes]
    if cfg.model == "gin":
        return [(None, d) if d < cfg.hidden else (d, cfg.hidden)
                for d in dims[:-1]]
    if cfg.model == "gat":
        return [(None, d) for d in dims[:-1]]
    return list(zip(dims[:-1], dims[1:]))


def layer_epilogues(cfg: GNNConfig, in_dim: int, n_classes: int) -> tuple:
    """Per-layer EpilogueSpecs aligned with :func:`agg_width_pairs`."""
    dims = [in_dim] + [cfg.hidden] * (cfg.n_layers - 1) + [n_classes]
    return ep_mod.layer_epilogues(cfg.model, dims, cfg.hidden)


def layer_plan_inputs(cfg: GNNConfig, in_dim: int, n_classes: int,
                      dec: dec_mod.Decomposed | None = None,
                      dtype=torch.float32, hw=None) -> tuple[list, tuple]:
    """``(pairs, epilogues)`` for selection.

    Without ``dec`` they are :func:`agg_width_pairs` and
    :func:`layer_epilogues`, GIN's structure by the width rule.  With
    ``dec``, each GIN layer whose hidden width exceeds its input width is
    priced: both structures go through ``selector.plan_layer_cost`` under
    ``hw`` (default: ``dec``'s device's model), the MLP's dense terms
    included, and the cheaper one is committed on the layer's
    EpilogueSpec (transform-first on a tie)."""
    pairs = agg_width_pairs(cfg, in_dim, n_classes)
    eps = layer_epilogues(cfg, in_dim, n_classes)
    if dec is None or cfg.model != "gin":
        return pairs, eps
    hw = hw or sel_mod.default_hw(dec.device)
    dims = [in_dim] + [cfg.hidden] * (cfg.n_layers - 1) + [n_classes]
    pairs, eps = list(pairs), list(eps)
    for i in range(cfg.n_layers):
        fin = dims[i]
        if cfg.hidden <= fin:
            continue        # transform-first narrows the pass: keep it
        (tf_pair, tf_spec), (af_pair, af_spec) = \
            ep_mod.gin_structure_candidates(fin, cfg.hidden, dims[i + 1])
        tf_cost = sel_mod.plan_layer_cost(dec, tf_pair[1], dtype, hw=hw,
                                          in_dim=tf_pair[0],
                                          epilogue=tf_spec)
        af_cost = sel_mod.plan_layer_cost(dec, af_pair[1], dtype, hw=hw,
                                          in_dim=af_pair[0],
                                          epilogue=af_spec)
        pairs[i], eps[i] = ((af_pair, af_spec) if af_cost < tf_cost
                            else (tf_pair, tf_spec))
    return pairs, tuple(eps)


def select_plan(dec: dec_mod.Decomposed, cfg: GNNConfig, widths: list,
                dtype=torch.float32, epilogues: tuple | None = None
                ) -> tuple[KernelPlan, dict]:
    """Commit a KernelPlan with ``cfg.selector``; returns ``(plan,
    probe_times)``.

    ``widths`` holds aggregated widths (ints) or ``(in_dim, agg_dim)``
    pairs (:func:`agg_width_pairs`): with an in_dim, fused candidates
    compete.  ``dtype`` is the aggregation dtype the probes run in.
    ``feedback`` times every candidate on ``dec``'s device (CUDA events
    on CUDA) at each distinct width pair, ``warmup_iters`` calls each
    after one untimed call, and commits the fastest per subgraph;
    ``probe_times`` maps ``(subgraph, kernel, agg_dim)`` to the median
    seconds.  ``cost_model`` ranks by ``selector.default_hw(dec.device)``;
    ``fixed`` applies ``cfg.fixed_kernels`` and probes nothing."""
    pairs = [(None, w) if isinstance(w, int) else tuple(w) for w in widths]
    eps = tuple(epilogues) if epilogues is not None else (None,) * len(pairs)
    probe_times: dict = {}
    if cfg.selector == "fixed":
        plan = KernelPlan.make(dec, tuple(cfg.fixed_kernels),
                               n_layers=len(pairs), epilogues=eps)
    elif cfg.selector == "cost_model":
        hw = sel_mod.default_hw(dec.device)
        plan = KernelPlan.make(
            dec, [sel_mod.select_by_cost_model(dec, fout, dtype, hw=hw,
                                               in_dim=fin, epilogue=ep)
                  for (fin, fout), ep in zip(pairs, eps)],
            epilogues=eps)
    elif cfg.selector == "feedback":
        fused_ok = any(fin is not None for fin, _ in pairs)
        sel = sel_mod.AdaptiveSelector(dec, warmup_iters=cfg.warmup_iters,
                                       include_fused=fused_ok)
        ep_of = dict(zip(pairs, eps))
        dev = dec.device
        for fin, fout in sorted(set(pairs), key=lambda p: (p[1], p[0] or 0)):
            probe_x = torch.ones((dec.n_pad, fout), dtype=dtype, device=dev)
            transform = (None if fin is None else
                         (torch.ones((dec.n_pad, fin), dtype=dtype,
                                     device=dev),
                          torch.ones((fin, fout), dtype=dtype, device=dev)))
            ep = ep_of[(fin, fout)]
            res = sel.probe(probe_x, iters=cfg.warmup_iters,
                            transform=transform,
                            free_transform=bool(ep and ep.free_transform))
            probe_times.update({k + (fout,): v for k, v in res.times.items()})
        # keyed by the full pair: layers of one output width but different
        # input widths may commit different kernels
        plan = KernelPlan.make(
            dec, [sel.choice(fout if fin is None else (fin, fout))
                  for fin, fout in pairs], epilogues=eps)
    else:
        raise ValueError(f"unknown selector {cfg.selector!r}")
    return plan, probe_times


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


def _loss(params, cfg, dec, x, labels, node_mask, plan,
          acc: bool | None = None) -> torch.Tensor:
    """Mean negative log-likelihood over the real (masked) nodes."""
    logits = forward(params, cfg, dec, x, plan, acc=acc)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    nll = torch.where(node_mask, nll, torch.zeros_like(nll))
    return nll.sum() / node_mask.sum().clamp(min=1)


def make_train_step(cfg: GNNConfig, dec: dec_mod.Decomposed, kernels, *,
                    acc: bool | None = None):
    """Full-graph step with Adam over a fixed KernelPlan: ``step(params,
    opt, x, labels, node_mask) -> (params, opt, loss)``.  It never writes
    into the parameters or moments it is given; the loss is that of the
    parameters passed in, as in the reference.  ``acc`` is
    :func:`forward`'s (``train`` leaves it to the device)."""
    plan = _as_plan(dec, kernels, cfg.n_layers)

    def step(params, opt, x, labels, node_mask):
        leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
                  for layer in params]
        loss = _loss(leaves, cfg, dec, x, labels, node_mask, plan, acc)
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
          params: list[dict] | None = None):
    """Training on ``device``, as the reference's ``train``: full-batch,
    returning a :class:`TrainResult`, or with ``cfg.sampler`` other than
    ``"full"`` mini-batch training over sampled subgraphs
    (``train.gnn_steps.train_minibatch``), returning its
    ``MinibatchResult``.

    ``params`` are the initial parameters (e.g. the reference's, through
    ``repro_torch.weights.from_jax_params``); they are copied to ``device``
    and never written into.  With None they are drawn by
    :func:`init_model` from ``cfg.seed`` (torch's numbers, not
    ``jax.random``'s)."""
    if cfg.sampler != "full":
        from repro_torch.train import gnn_steps   # lazy: import cycle
        return gnn_steps.train_minibatch(graph, cfg, steps=steps,
                                         verbose=verbose, device=device,
                                         params=params)
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

    pairs, eps = layer_plan_inputs(cfg, in_dim, n_classes, dec=dec,
                                   dtype=x.dtype)
    plan, probe_times = select_plan(dec, cfg, pairs, dtype=x.dtype,
                                    epilogues=eps)
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
