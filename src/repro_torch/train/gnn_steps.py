"""Mini-batch GNN training: sampled subgraphs through the AdaptGear stack.

Counterpart of ``repro/train/gnn_steps.py``, its synchronous path.  Per
step (host side): sample a fixed-shape :class:`SampledBatch`, partition it
once into a decomposition skeleton, look its quantized density signature
up in the :class:`PlanCache` (cost-model selection on a miss), materialize
only the committed plan's payloads, pad them to the edge budget and copy
them to the device, then run the step.  The step function is one per
committed :class:`KernelPlan`; it records the shapes and dtypes of the
first batch it sees (every payload tensor, the features, labels and
masks) and checks every later batch against that record, so a batch that
would retrace the reference's jitted step raises here instead
(``n_traces`` counts the records, as the reference counts traces).

The loop mirrors :func:`repro_torch.core.gnn.train` (same models, same
hand-written Adam, the same masked cross-entropy, here masked to the
batch's target nodes) over ``steps`` sampled batches.  With
``cfg.nonfinite_guard`` a batch whose loss or any gradient is NaN or Inf
leaves params and the whole Adam state (``t`` included) as they were, and
is counted (``faults["nonfinite_skips"]``).

Not ported yet, and refused with ``NotImplementedError`` naming their
ROADMAP item: the asynchronous pipeline (``prefetch_depth > 0``),
checkpoint/resume, retries, and kernel quarantine on a failure (the
PlanCache keeps its quarantine bookkeeping as data).
"""
from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import decompose as dec_mod
from repro_torch.core import formats, gnn, selector as sel_mod
from repro_torch.core.plan import KernelPlan
from repro_torch.graphs import graph as graph_mod
from repro_torch.obs import Telemetry, enable_verbose, get_logger
from repro_torch.sampling.plan_cache import (MB_KERNELS, PlanCache,
                                             fix_shapes, plan_payload_keys)
from repro_torch.sampling.sampler import (ClusterSampler, NeighborSampler,
                                          SampledBatch)

_log = get_logger("repro_torch.train")

MINIBATCH_MODELS = ("gcn", "gin", "sage")


def make_sampler(graph: graph_mod.Graph, cfg: gnn.GNNConfig):
    """Sampler from the GNNConfig knobs (cfg.sampler: cluster | neighbor).
    Cluster blocks are the decomposition's community size, so per-batch
    ``decompose(reorder=False)`` sees cluster-aligned diagonal blocks."""
    if cfg.sampler == "cluster":
        return ClusterSampler(
            graph, block=cfg.comm_size,
            clusters_per_batch=cfg.clusters_per_batch, method=cfg.reorder,
            edge_budget=cfg.edge_budget or None, seed=cfg.seed)
    if cfg.sampler == "neighbor":
        return NeighborSampler(
            graph, batch_nodes=cfg.batch_nodes, fanouts=cfg.fanouts,
            method=cfg.reorder, block=cfg.comm_size, seed=cfg.seed)
    raise ValueError(f"unknown sampler {cfg.sampler!r} "
                     "(expected 'cluster' or 'neighbor')")


def batch_edge_budget(batch: SampledBatch, cfg: gnn.GNNConfig) -> int:
    """Padded edge-slot count the fixed-shape payloads are built to: the
    sampler's edge budget plus one self-loop slot per (padded) node for
    GCN."""
    return len(batch.senders) + (batch.n if cfg.model == "gcn" else 0)


def prepare_skeleton(batch: SampledBatch, cfg: gnn.GNNConfig,
                     bell_slack: float | None = None
                     ) -> tuple[dec_mod.DecomposeSkeleton, np.ndarray]:
    """Per-batch preprocessing: the model's edge normalization over the
    sampled subgraph (GCN: self-loops and the symmetric norm; SAGE: the
    mean aggregator's 1/deg baked into the edge values) and one
    partition-and-stats pass into a skeleton with a pinned bucket count
    and the edge budget (and the PlanCache's adapted ``bell_slack``) in
    its tier stats.  Also returns the batch's inverse in-degree (the
    reference's step argument; the baked SAGE path does not read it)."""
    s, r = batch.real_edges()
    vals = None
    if cfg.model == "gcn":
        loops = batch.node_mask.nonzero()[0].astype(np.int32)
        s = np.concatenate([s, loops])
        r = np.concatenate([r, loops])
        vals = graph_mod.gcn_norm_values(batch.n, s, r)
    elif cfg.model == "sage":
        vals = graph_mod.mean_norm_values(batch.n, s, r)
    g = graph_mod.Graph(batch.n, s, r, batch.features, batch.labels,
                        n_classes=1, name="batch")
    skel = dec_mod.decompose_skeleton(
        g, comm_size=cfg.comm_size, reorder=False,
        inter_buckets=max(cfg.inter_buckets, 1), edge_vals=vals,
        keep_empty_buckets=True, edge_budget=batch_edge_budget(batch, cfg),
        bell_slack=bell_slack)
    deg = np.bincount(r, minlength=batch.n).astype(np.float32)
    inv_deg = np.where(batch.node_mask, 1.0 / np.maximum(deg, 1.0), 0.0)
    return skel, inv_deg.astype(np.float32)


def prepare_batch(batch: SampledBatch, cfg: gnn.GNNConfig,
                  kernels: tuple = MB_KERNELS,
                  device: str | torch.device | None = DEFAULT_DEVICE
                  ) -> tuple[dec_mod.Decomposed, np.ndarray]:
    """Skeleton and materialize in one call: the decomposition (real,
    unpadded payloads of ``kernels`` on ``device``, host numpy where it is
    None) and the inverse in-degree."""
    skel, inv_deg = prepare_skeleton(batch, cfg)
    return skel.materialize(kernels, device=device), inv_deg


def step_args(batch: SampledBatch, dec: dec_mod.Decomposed,
              inv_deg: np.ndarray, plan: KernelPlan, edge_budget: int,
              device: torch.device, stats: tuple | None = None) -> tuple:
    """The step's argument tail ``(dec, x, labels, target_mask,
    inv_deg)`` on ``device``: the plan's payloads padded to the edge
    budget (:func:`fix_shapes`) and copied there, labels as int64."""
    fixed = fix_shapes(dec, edge_budget, keep=plan_payload_keys(plan),
                       stats=stats).to(device)
    as_dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (fixed, as_dev(batch.features),
            as_dev(batch.labels.astype(np.int64)),
            as_dev(batch.target_mask), as_dev(inv_deg))


def _tensor_shapes(args) -> tuple:
    """(shape, dtype) of every tensor of a step's argument tail, payloads
    in a fixed order (tier, format key, container, field)."""
    dec, *rest = args
    out = []
    for sub in dec.subgraphs:
        for key in sorted(sub.formats):
            p = sub.formats[key]
            for c in (p if isinstance(p, tuple) else (p,)):
                for f in formats.ARRAY_FIELDS[type(c)]:
                    a = getattr(c, f)
                    out.append((sub.name, key, f, tuple(a.shape), a.dtype))
    out += [(tuple(a.shape), a.dtype) for a in rest]
    return tuple(out)


def _cap_key(dec: dec_mod.Decomposed) -> tuple:
    """The budget caps of a decomposition's capped payloads (blocked-ELL
    K, tcgnn C): the shapes a budget-K slack step changes on purpose."""
    caps = []
    for sub in dec.subgraphs:
        for key in ("bell", "tcgnn_tile"):
            p = sub.formats.get(key)
            if p is not None:
                caps.append((sub.name, key, getattr(p[0], "max_blocks",
                                                    None),
                             getattr(p[0], "n_cond", None)))
    return tuple(caps)


class _ShapeRecord:
    """One plan's step-function shape contract.  The first batch of each
    budget cap (a budget-K slack step changes the caps, which retraces the
    reference's step) is recorded and counted in ``counters["traces"]``;
    a later batch with the same caps must have exactly its shapes and
    dtypes, or :meth:`check` raises (the reference would retrace)."""

    def __init__(self, plan: KernelPlan, counters: dict):
        self.plan = plan
        self.counters = counters
        self.records: dict[tuple, tuple] = {}

    def check(self, args) -> None:
        key = _cap_key(args[0])
        shapes = _tensor_shapes(args)
        seen = self.records.get(key)
        if seen is None:
            self.records[key] = shapes
            self.counters["traces"] += 1
        elif seen != shapes:
            diff = [(a, b) for a, b in zip(seen, shapes) if a != b][:3]
            raise RuntimeError(
                f"plan {self.plan.layers}: batch shapes differ from the "
                f"first batch of this plan ({diff}); fix_shapes must give "
                "every batch of one sampler the same shapes")


def make_sampled_step(cfg: gnn.GNNConfig, plan: KernelPlan, counters: dict):
    """``step(params, opt, dec, x, labels, target_mask, inv_deg) ->
    (params, opt, loss, finite)`` for one committed plan.

    ``dec`` is an argument (its payloads change every batch, its shapes
    do not): the first batch's shapes are recorded and every later batch
    is checked against them (``counters["traces"]`` counts the records).
    The step never writes into the params or moments it is given.  With
    ``cfg.nonfinite_guard`` the update is skipped when the loss or any
    gradient is not finite: the params and the whole Adam state (``t``
    included) come back as they were, and ``finite`` is False.  The
    decision reads one flag on the host, beside the loss the loop reads
    anyway."""
    record = _ShapeRecord(plan, counters)
    guard = cfg.nonfinite_guard

    def step(params, opt, dec, x, labels, target_mask, inv_deg):
        record.check((dec, x, labels, target_mask, inv_deg))
        leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
                  for layer in params]
        loss = gnn._loss(leaves, cfg, dec, x, labels, target_mask, plan)
        flat = [v for layer in leaves for v in layer.values()]
        flat_g = torch.autograd.grad(loss, flat)
        loss = loss.detach()
        if guard:
            finite = torch.stack([torch.isfinite(loss)] + [
                torch.isfinite(g).all() for g in flat_g]).all()
            if not bool(finite):
                return params, opt, loss, False
        it = iter(flat_g)
        grads = [{k: next(it) for k in layer} for layer in leaves]
        new_params, new_opt = gnn._adam_update(params, grads, opt, cfg.lr)
        return new_params, new_opt, loss, True

    step.record = record
    return step


def make_infer_step(cfg: gnn.GNNConfig, plan: KernelPlan, counters: dict):
    """``infer(params, dec, x, inv_deg) -> logits``: the forward pass the
    train step differentiates, with the same shape contract
    (``counters["traces"]`` counts its records).  Returns the full
    (node_budget, n_classes) logits."""
    record = _ShapeRecord(plan, counters)

    def infer(params, dec, x, inv_deg):
        record.check((dec, x, inv_deg))
        with torch.no_grad():
            return gnn.forward(params, cfg, dec, x, plan)

    infer.record = record
    return infer


@dataclass
class MinibatchResult:
    losses: list
    accuracy: float
    cache: dict                  # PlanCache.stats snapshot
    hit_history: list            # per-step cache hit booleans
    plans: list                  # distinct plan layer tuples, first-seen order
    n_traces: int                # step shape records (reference: jit traces)
    step_seconds: float          # median step wall time (after the first)
    sample_seconds: float        # median sampler time per batch
    prepare_seconds: float       # median skeleton+select+pad+copy per batch
    dropped_edges: int           # edges truncated by the budget, total
    plan_cache: Any = None
    skeleton_hits: int = 0       # batches whose cluster tuple reused a
    skeleton_misses: int = 0     # cached DecomposeSkeleton (ClusterSampler)
    iter_seconds: float = 0.0    # median wall time of one whole iteration
    faults: dict | None = None   # retries, quarantined, recoveries,
    #                              nonfinite_skips, checkpoints, resumed_at
    telemetry: dict | None = None  # Telemetry.summary()
    params: Any = None           # trained model params
    # port only: the committed plan layers of each training batch and of
    # each eval batch (what their steps and forwards launched); the median
    # host seconds of each prepare stage: sample, skeleton (partition +
    # stats), lookup (PlanCache, selection on a miss), materialize (the
    # plan's payloads, padded, on the device); and per capped payload
    # key the training batches' [spilled, all] edges of the tiers that
    # dispatched it
    plan_history: list | None = None
    eval_plans: list | None = None
    stage_seconds: dict | None = None
    spill: dict | None = None

    def hit_rate(self, warmup: int = 0) -> float:
        h = self.hit_history[warmup:]
        return sum(h) / max(len(h), 1)


class SkeletonCache:
    """Cluster-tuple -> (skeleton, inv_deg) memo.  ClusterSampler draws
    cluster combinations without replacement per epoch, so tuples recur
    across epochs; a batch drawn for a tuple is fully determined by it
    unless the edge budget truncated a random subset (never cached).  The
    adapted bell slack is part of the key."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(batch: SampledBatch, bell_slack) -> tuple | None:
        clusters = batch.meta.get("clusters")
        if clusters is None or batch.meta.get("dropped_edges", 0):
            return None
        return (tuple(clusters), bell_slack)

    def get(self, key: tuple):
        hit = self._entries.get(key)
        if hit is not None:
            self.hits += 1
            self._entries.move_to_end(key)
        return hit

    def put(self, key: tuple, value: tuple) -> None:
        self.misses += 1
        self._entries[key] = value
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)


@dataclass
class _InFlight:
    """One batch between the loop's stages: built (skeleton), resolved
    (plan, hit, canonical signature: every shared-cache decision), then
    finished (payloads padded and on the device)."""
    batch: SampledBatch
    skel: dec_mod.DecomposeSkeleton
    inv_deg: np.ndarray
    dec: dec_mod.Decomposed | None = None
    plan: KernelPlan | None = None
    sig: tuple | None = None
    hit: bool = False


def _refuse_unported(cfg: gnn.GNNConfig, fault_plan) -> None:
    """The reference's knobs this port does not run yet: each raises,
    naming the ROADMAP item that ports it, and never falls back."""
    if cfg.prefetch_depth > 0:
        raise NotImplementedError(
            "prefetch_depth > 0 (the asynchronous batch pipeline, "
            "train/pipeline.py) is not ported yet: ROADMAP section 1 item 6")
    for name, on in (("checkpoint_dir", bool(cfg.checkpoint_dir)),
                     ("checkpoint_every", cfg.checkpoint_every > 0),
                     ("resume_from", bool(cfg.resume_from)),
                     ("retry_max", cfg.retry_max > 0),
                     ("fault_plan", fault_plan is not None)):
        if on:
            raise NotImplementedError(
                f"{name} (checkpoint/resume, retries and kernel quarantine)"
                " is not ported yet: ROADMAP section 1 item 7")


def train_minibatch(graph: graph_mod.Graph, cfg: gnn.GNNConfig,
                    steps: int = 50, verbose: bool = False,
                    eval_batches: int = 4,
                    plan_cache: PlanCache | None = None,
                    fault_plan=None,
                    telemetry: Telemetry | None = None, *,
                    device: str | torch.device = DEFAULT_DEVICE,
                    params: list[dict] | None = None) -> MinibatchResult:
    """Mini-batch driver on ``device``: Graph -> Sampler -> SampledBatch ->
    skeleton -> PlanCache -> payloads on the device -> step, with per-stage
    host timings and cache accounting.

    Selector modes: ``fixed`` dispatches ``cfg.fixed_kernels`` every batch
    (no cache lookup; they must be budget-paddable, e.g. ``("block_diag",
    "bell")``); ``feedback`` and ``cost_model`` both select by the cost
    model of ``device`` through the PlanCache, and ``cfg.probe_every``
    times the top candidates on every Nth miss and pins the winner.

    ``params`` are the initial parameters (e.g. the reference's, through
    ``repro_torch.weights.from_jax_params``), copied to ``device`` and
    never written into; None draws them from ``cfg.seed``.  ``telemetry``
    (or ``cfg.telemetry`` / ``trace_out`` / ``telemetry_out``) turns on
    the span tracer and the selector audit; they never feed back into a
    decision, so losses, plans, hit history and ``n_traces`` are the same
    with them on or off.  ``fault_plan`` and the unported knobs raise
    (:func:`_refuse_unported`)."""
    if cfg.model not in MINIBATCH_MODELS:
        raise ValueError(f"mini-batch training supports gcn/gin/sage, "
                         f"not {cfg.model!r}")
    _refuse_unported(cfg, fault_plan)
    dev = resolve_device(device)
    if verbose:
        enable_verbose("repro_torch.train")
    tele = (telemetry if telemetry is not None
            else Telemetry(enabled=bool(cfg.telemetry or cfg.trace_out
                                        or cfg.telemetry_out)))
    tracer = tele.tracer
    fixed_names = (tuple(cfg.fixed_kernels) if cfg.selector == "fixed"
                   else None)
    audited_fixed_sigs: set = set()   # one plan receipt per pinned signature
    sampler = make_sampler(graph, cfg)
    in_dim = graph.features.shape[-1]
    pairs = gnn.agg_width_pairs(cfg, in_dim, graph.n_classes)
    epilogues = gnn.layer_epilogues(cfg, in_dim, graph.n_classes)
    # total budget the padded payloads see: sampled edges + GCN self-loops
    pad_budget = sampler.edge_budget + (sampler.node_budget
                                        if cfg.model == "gcn" else 0)
    if plan_cache is not None:
        plan_cache.attach_telemetry(tele)
    cache = plan_cache or PlanCache(pairs, dtype=np.float32,
                                    hw=sel_mod.default_hw(dev),
                                    max_entries=cfg.cache_entries,
                                    probe_every=cfg.probe_every,
                                    edge_budget=pad_budget,
                                    epilogues=epilogues,
                                    probe_k_max=cfg.probe_k_max,
                                    probe_budget_s=cfg.probe_budget_s,
                                    adapt_budget_k=cfg.adapt_budget_k,
                                    max_slack_changes=(
                                        cfg.max_ladder_recompiles),
                                    telemetry=tele, device=dev)
    skel_cache = (SkeletonCache(cfg.skeleton_cache_entries)
                  if cfg.skeleton_cache_entries > 0 else None)

    if params is None:
        params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                                in_dim, graph.n_classes, dev)
    else:
        params = [{k: v.detach().to(dev, torch.float32).clone()
                   for k, v in layer.items()} for layer in params]
    opt = gnn._adam_init(params)

    fault = {k: tele.metrics.counter(f"faults.{k}")
             for k in ("retries", "quarantined", "recoveries",
                       "nonfinite_skips", "checkpoints")}
    f_resumed = tele.metrics.gauge("faults.resumed_at")
    f_resumed.set(-1)

    # canonical signature per step function (= plan.layers): the first
    # one seen for a layer tuple, stamped on every padded decomposition
    sig_of_layers: dict[tuple, tuple] = {}
    counters = dict(traces=0)
    step_fns: dict[tuple, Any] = {}     # plan.layers -> step, first-use order

    def get_step_fn(plan):
        fn = step_fns.get(plan.layers)
        if fn is None:
            fn = step_fns[plan.layers] = make_sampled_step(cfg, plan,
                                                           counters)
        return fn

    def skeleton_for(batch, slack):
        skey = (SkeletonCache.key(batch, slack) if skel_cache is not None
                else None)
        cached = skel_cache.get(skey) if skey is not None else None
        if cached is not None:
            return cached
        skel, inv_deg = prepare_skeleton(batch, cfg, bell_slack=slack)
        if skey is not None:
            skel_cache.put(skey, (skel, inv_deg))
        return skel, inv_deg

    def build_batch(batch) -> _InFlight:
        """The partition pass into a skeleton (through the SkeletonCache),
        plus the fixed selector's host payloads."""
        with tracer.span("build", cat="host"):
            slack = cache.bell_slack if cfg.adapt_budget_k else None
            skel, inv_deg = skeleton_for(batch, slack)
            c = _InFlight(batch=batch, skel=skel, inv_deg=inv_deg)
            if fixed_names is not None:
                c.dec = skel.materialize(fixed_names, device=None)
                c.plan = KernelPlan.make(c.dec, fixed_names,
                                         n_layers=cfg.n_layers,
                                         epilogues=epilogues)
        return c

    def resolve_batch(c: _InFlight) -> _InFlight:
        """Every shared-cache decision, in batch order: the PlanCache
        lookup (selection on a miss), the budget-K spill feedback, the
        canonical signature, the step function's place in first-use
        order."""
        with tracer.span("resolve", cat="host"):
            if fixed_names is not None:
                c.hit = True
                if tele.audit.enabled:
                    sig = cache.signature(c.dec)
                    if sig not in audited_fixed_sigs:
                        audited_fixed_sigs.add(sig)
                        modeled = sel_mod.plan_modeled_costs(
                            c.dec, c.plan.layers, cache.pairs, cache.dtype,
                            hw=cache.hw, epilogues=cache.epilogues)
                        tele.audit.plan(
                            sig=sig, layers=c.plan.layers,
                            tiers=[s.name for s in c.dec.subgraphs],
                            modeled_s=modeled, source="fixed")
            else:
                c.plan = cache.lookup(c.skel)
                c.hit = c.plan is not None
                if not c.hit:
                    c.dec = c.skel.materialize(MB_KERNELS, device=None)
                    c.plan, _ = cache.plan_for(c.dec)
                elif cfg.adapt_budget_k:
                    # the spill feedback steps the slack ladder, so it
                    # observes the committed payloads here, in order
                    c.dec = c.skel.materialize(plan_payload_keys(c.plan),
                                               device=None)
            if c.dec is not None:
                cache.observe_bell(c.dec)
            c.sig = sig_of_layers.setdefault(c.plan.layers,
                                             cache.signature(c.skel))
            get_step_fn(c.plan)
        return c

    spill = {}

    def finish_batch(c: _InFlight, count_spill: bool = True) -> tuple:
        """The plan's payloads padded to the budget and, with the batch,
        copied to the device: the step's argument tail."""
        with tracer.span("finish", cat="host"):
            keys = plan_payload_keys(c.plan)
            if c.dec is None:
                c.dec = c.skel.materialize(keys, device=None)
            for sub, ks in zip(c.dec.subgraphs, keys):
                for key in ks & {"bell", "tcgnn_tile"} if count_spill else ():
                    acc = spill.setdefault(key, [0, 0])
                    acc[0] += sub.formats[key][2].nnz
                    acc[1] += sub.stats["nnz"]
            return step_args(c.batch, c.dec, c.inv_deg, c.plan, pad_budget,
                             dev, stats=c.sig)

    losses, hit_history, plan_history = [], [], []
    times = {k: [] for k in ("sample", "skeleton", "lookup", "materialize",
                             "step", "iter")}
    dropped = 0

    def timed(stage, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        times[stage].append(time.perf_counter() - t0)
        return out

    for i in range(steps):
        it0 = time.perf_counter()
        with tracer.span("sample", cat="host", index=i):
            batch = timed("sample", lambda: sampler.build(sampler.draw()))
        c = timed("skeleton", build_batch, batch)
        c = timed("lookup", resolve_batch, c)
        args = timed("materialize", finish_batch, c)
        dropped += batch.meta.get("dropped_edges", 0)
        hit_history.append(c.hit)
        plan_history.append(c.plan.layers)
        t0 = time.perf_counter()
        with tracer.span("device_step", cat="device", index=i, hit=c.hit):
            params, opt, loss, finite = get_step_fn(c.plan)(params, opt,
                                                            *args)
            loss_f = float(loss)
        dt = time.perf_counter() - t0
        times["step"].append(dt)
        tele.audit.observe_step(c.plan.layers, dt)
        if not finite:
            fault["nonfinite_skips"].inc()
        losses.append(loss_f)
        times["iter"].append(time.perf_counter() - it0)
        if i % 10 == 0 and _log.isEnabledFor(logging.INFO):
            cs = cache.stats
            _log.info(f"batch {i:4d} loss {loss_f:.4f} cache_hit={c.hit} "
                      f"plan={c.plan.layers[0]} cache[h={cs['hits']} "
                      f"nh={cs['near_hits']} m={cs['misses']} "
                      f"ev={cs['evictions']} pr={cs['probes']} "
                      f"rate={cs['hit_rate']:.2f}]")

    # the training steady state, before the eval batches' own lookups
    cache_stats = dict(cache.stats)
    plans_trained = list(step_fns)

    # masked accuracy over a few fresh batches
    correct = total = 0
    eval_plans = []
    for _ in range(eval_batches):
        batch = sampler.sample()
        c = resolve_batch(build_batch(batch))
        eval_plans.append(c.plan.layers)
        dec, x, labels, tm, _ = finish_batch(c, count_spill=False)
        with torch.no_grad():
            pred = gnn.forward(params, cfg, dec, x, c.plan).argmax(-1)
        correct += int(((pred == labels) & tm).sum())
        total += int(tm.sum())

    if tele.enabled and (cfg.trace_out or cfg.telemetry_out):
        tele.export(trace_out=cfg.trace_out or None,
                    jsonl_out=cfg.telemetry_out or None)

    def med(ts, skip=0):
        return float(np.median(ts[skip:])) if ts[skip:] else 0.0

    prepare = [a + b + c for a, b, c in zip(times["skeleton"],
                                            times["lookup"],
                                            times["materialize"])]
    faults = {k: cnt.value for k, cnt in fault.items()}
    faults["resumed_at"] = f_resumed.value
    return MinibatchResult(
        losses=losses, accuracy=correct / max(total, 1),
        cache=cache_stats, hit_history=hit_history, plans=plans_trained,
        n_traces=counters["traces"],
        step_seconds=med(times["step"], skip=min(len(times["step"]) - 1, 1)),
        sample_seconds=med(times["sample"]), prepare_seconds=med(prepare),
        iter_seconds=med(times["iter"], skip=min(len(times["iter"]) - 1, 1)),
        dropped_edges=dropped, plan_cache=cache,
        skeleton_hits=skel_cache.hits if skel_cache else 0,
        skeleton_misses=skel_cache.misses if skel_cache else 0,
        faults=faults, telemetry=tele.summary(), params=params,
        plan_history=plan_history, eval_plans=eval_plans, spill=spill,
        stage_seconds={k: med(times[k]) for k in ("sample", "skeleton",
                                                  "lookup", "materialize")})
