"""Full-batch GCN inference on top of AdaptGear aggregation.

Counterpart of the read path of ``repro/core/gnn.py``:
``prepare`` -> ``init_model`` -> ``select_plan`` -> ``forward``.  Ported so
far: the GCN model and the ``fixed`` selector with the paper's default
plan ``("block_diag", "bell")``.  Other models, selectors, bucket
autotuning and training raise ``NotImplementedError`` naming the ROADMAP
slice that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass

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
    selector: str = "fixed"
    fixed_kernels: tuple = ("block_diag", "bell")
    seed: int = 0


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
