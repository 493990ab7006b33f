"""Mini-batch GNN training: sampled subgraphs through the AdaptGear stack.

Counterpart of ``repro/train/gnn_steps.py``.  Per step (host side):
sample a fixed-shape :class:`SampledBatch`, partition it once into a
decomposition skeleton, look its quantized density signature up in the
:class:`PlanCache` (cost-model selection on a miss), materialize only the
committed plan's payloads, pad them to the edge budget and copy them to
the device, then run the step.  The step function is one per committed
:class:`KernelPlan`; it records the shapes and dtypes of the first batch
it sees (every payload tensor, the features, labels and masks) and checks
every later batch against that record, so a batch that would retrace the
reference's jitted step raises here instead (``n_traces`` counts the
records, as the reference counts traces).

The loop mirrors :func:`repro_torch.core.gnn.train` (same models, same
hand-written Adam, the same masked cross-entropy, here masked to the
batch's target nodes) over ``steps`` sampled batches.

``cfg.prefetch_depth > 0`` runs the host prepare on the asynchronous
pipeline (``train/pipeline.py``): ``cfg.pipeline_workers`` threads build,
resolve (in batch order) and finish batches up to ``prefetch_depth``
ahead, staging each batch's copy to the card on a stream of their own,
and the loop becomes a consumer of ready batches.  Batches, plans, cache
counters, ``n_traces`` and losses are the synchronous loop's, bit for
bit where the device's arithmetic is deterministic.

Fault tolerance, as in the reference:

* **crash-safe checkpoint/resume**: every ``cfg.checkpoint_every``
  consumed batches the loop saves params and Adam state
  (``distributed/checkpoint.py``) with an aux payload: the batch cursor,
  the PlanCache state, the plans and their canonical signatures in
  step-function order, and the losses, hits and plans so far.  The cache
  snapshot is taken in the batch-ordered resolve stage, so batches the
  pipeline resolved ahead never leak into it.  Batch i is a pure function
  of (seed, i), so ``cfg.resume_from`` replays from the cursor to the
  uninterrupted run's losses, plans and hits.
* **non-finite guard** (``cfg.nonfinite_guard``): a batch whose loss or
  any gradient is NaN or Inf leaves params and the whole Adam state
  (``t`` included) as they were, and is counted
  (``faults["nonfinite_skips"]``).
* **transient-failure retry** (``cfg.retry_max > 0``): the sampler build
  and skeleton of a batch (the sync loop's, and the pipeline's racing
  stages) retry with bounded exponential backoff on the failures
  ``distributed.fault_tolerance.default_transient`` accepts, and nothing
  wider; retries are counted (``faults["retries"]``).  A kernel that
  fails to build or launch, a shape-record mismatch and an
  out-of-memory error are fatal: the run fails at once, with no retry, no
  other plan and no plain version.
* **fault injection** (``fault_plan``, a ``FaultPlan``): transient and
  fatal faults at a batch's build, NaN features, and a simulated crash
  after a batch commits, at the reference's points.

Not ported yet: kernel quarantine with its degrade to the next plan (the
PlanCache keeps its quarantine bookkeeping as data); a ``FaultPlan`` with
``kernel_faults`` raises ``NotImplementedError`` naming ROADMAP section 1
item 7.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import decompose as dec_mod
from repro_torch.core import formats, gnn, selector as sel_mod
from repro_torch.core.plan import KernelPlan
from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.graphs import graph as graph_mod
from repro_torch.kernels import _build
from repro_torch.obs import Telemetry, enable_verbose, get_logger
from repro_torch.sampling.plan_cache import (MB_KERNELS, PlanCache,
                                             fix_shapes, plan_payload_keys)
from repro_torch.sampling.sampler import (ClusterSampler, NeighborSampler,
                                          SampledBatch)
from repro_torch.train.pipeline import BatchPipeline

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
              device: torch.device, stats: tuple | None = None,
              copy=None) -> tuple:
    """The step's argument tail ``(dec, x, labels, target_mask,
    inv_deg)`` on ``device``: the plan's payloads padded to the edge
    budget (:func:`fix_shapes`) and copied there, labels as int64.
    ``copy(host_array) -> tensor`` replaces the plain copy (the
    pipeline's staging copy, :class:`_Stager`)."""
    if copy is None:
        copy = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    fixed = fix_shapes(dec, edge_budget, keep=plan_payload_keys(plan),
                       stats=stats).to(device, copy=copy)
    return (fixed, copy(batch.features),
            copy(batch.labels.astype(np.int64)),
            copy(batch.target_mask), copy(inv_deg))


class _Stager:
    """The pipeline workers' copy to the card: each worker thread stages
    on a CUDA stream of its own, from pinned host buffers, without
    blocking (a pageable copy on the default stream would queue behind
    the consumer's step and stall the worker).  :meth:`stage` returns the
    argument tail, an event recorded after its copies, and the tensors it
    made; the consumer waits on the event and records its own stream on
    each tensor (:meth:`hand_over`) before the step reads them."""

    def __init__(self, device: torch.device):
        self.device = device
        self._local = threading.local()

    def stage(self, make_args) -> tuple:
        """``make_args(copy)`` on this thread's stream, ``copy`` being
        the staging copy: ``(args, event, staged tensors)``."""
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        staged = []

        def copy(a):
            t = torch.as_tensor(a).pin_memory().to(self.device,
                                                   non_blocking=True)
            staged.append(t)
            return t

        with torch.cuda.stream(stream):
            args = make_args(copy)
            ready = torch.cuda.Event()
            ready.record(stream)
        return args, ready, staged

    @staticmethod
    def hand_over(ready, staged) -> None:
        """On the consumer: order its stream after the staging copies, and
        keep the caching allocator from reusing a staged tensor's memory
        on the worker's stream before the consumer's work on it is done."""
        consumer = torch.cuda.current_stream(staged[0].device)
        consumer.wait_event(ready)
        for t in staged:
            t.record_stream(consumer)


def tensor_shapes(args) -> tuple:
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
        shapes = tensor_shapes(args)
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
    is checked against them (``counters["traces"]`` counts the records;
    ``check=False`` skips the check for a caller that made it already
    through ``step.record``, as the training loop does in its finish
    stage).
    The step never writes into the params or moments it is given.  With
    ``cfg.nonfinite_guard`` the update is skipped when the loss or any
    gradient is not finite: the params and the whole Adam state (``t``
    included) come back as they were, and ``finite`` is False.  The
    decision reads one flag on the host, beside the loss the loop reads
    anyway."""
    record = _ShapeRecord(plan, counters)
    guard = cfg.nonfinite_guard

    def step(params, opt, dec, x, labels, target_mask, inv_deg, *,
             check: bool = True):
        if check:
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
    #                              (dequeue or prepare, then the step): the
    #                              overlap metric, async ~ max(step,
    #                              prepare), sync ~ their sum
    pipeline: dict | None = None  # BatchPipeline.stats + loop_seconds,
    #                               efficiency_pct (step time over
    #                               iteration time, the first iteration
    #                               left out), retries, quarantined,
    #                               nonfinite_skips; None on the sync path
    faults: dict | None = None   # retries, quarantined, recoveries,
    #                              nonfinite_skips, checkpoints, resumed_at
    #                              (-1: a fresh run); on a resumed run the
    #                              losses, hit_history, plan_history, spill
    #                              and dropped_edges hold the whole run
    #                              (restored prefix + new)
    telemetry: dict | None = None  # Telemetry.summary()
    params: Any = None           # trained model params
    # port only: the committed plan layers of each training batch and of
    # each eval batch (what their steps and forwards launched); the median
    # host seconds of each prepare stage: sample, skeleton (partition +
    # stats), lookup (PlanCache, selection on a miss), materialize (the
    # plan's payloads, padded, on the device), timed on the pipeline's
    # worker threads under the pipeline (where they race one another and
    # the consumer for the interpreter lock); and per capped payload
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
    adapted bell slack is part of the key.  get/put hold a lock, so the
    pipeline's workers share the memo (two racing one tuple both build,
    counted as two misses; entries are deterministic per key)."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(batch: SampledBatch, bell_slack) -> tuple | None:
        clusters = batch.meta.get("clusters")
        if clusters is None or batch.meta.get("dropped_edges", 0):
            return None
        return (tuple(clusters), bell_slack)

    def get(self, key: tuple):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                self._entries.move_to_end(key)
            return hit

    def put(self, key: tuple, value: tuple) -> None:
        with self._lock:
            self.misses += 1
            self._entries[key] = value
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)


@dataclass
class _InFlight:
    """One batch between the loop's stages: built (skeleton, racing),
    resolved in batch order (plan, hit, canonical signature: every
    shared-cache decision), then finished (racing: payloads padded and
    on the device, :class:`_Prepared`)."""
    batch: SampledBatch
    skel: dec_mod.DecomposeSkeleton
    inv_deg: np.ndarray
    slack: float | None          # bell slack the skeleton was built with
    times: dict                  # host seconds of each stage so far
    dec: dec_mod.Decomposed | None = None
    plan: KernelPlan | None = None
    sig: tuple | None = None
    hit: bool = False


@dataclass
class _Prepared:
    """One batch ready for its step, what the pipeline hands the consumer:
    the step's argument tail on the device, the batch's stage times and
    its capped payloads' spill ([spilled, all] edges per key), and, for a
    batch a worker staged, the event after its copies and the tensors
    they made (:meth:`_Stager.hand_over`)."""
    batch: SampledBatch
    plan: KernelPlan
    args: tuple
    hit: bool
    times: dict
    spill: dict
    ready: Any = None
    staged: list = field(default_factory=list)


def refuse_unported(fault_plan) -> None:
    """The reference's injected kernel faults need kernel quarantine,
    which this port does not run yet: raise, naming its ROADMAP item,
    and never fall back."""
    if fault_plan is not None and fault_plan.kernel_faults:
        raise NotImplementedError(ft.KERNEL_QUARANTINE_UNPORTED)


@contextlib.contextmanager
def _fatal(what: str):
    """Make every failure inside non-retryable: ``default_transient``
    reads an ``OSError`` as transient, and one here (a library that does
    not load, nvcc that does not start) must fail the run at once."""
    try:
        yield
    except Exception as exc:
        if not ft.default_transient(exc):
            raise
        raise RuntimeError(f"{what} failed: {exc!r}") from exc


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
    times the top candidates on every Nth miss and pins the winner (on a
    pipeline worker under the pipeline, as in the reference).

    ``cfg.prefetch_depth > 0`` prepares batches on the asynchronous
    pipeline (the module docstring): the batch stream, committed plans,
    cache counters, ``n_traces`` and losses are the synchronous loop's.
    With ``cfg.adapt_budget_k`` the committed payloads materialize in the
    ordered stage (the spill feedback that steps the slack ladder must see
    batches in order), which trades some overlap for determinism.
    ``cfg.checkpoint_dir`` with ``cfg.checkpoint_every`` saves a
    checkpoint after every ``checkpoint_every``-th batch, and
    ``cfg.resume_from`` resumes from the latest valid one (or warns and
    starts fresh when there is none).

    ``params`` are the initial parameters (e.g. the reference's, through
    ``repro_torch.weights.from_jax_params``), copied to ``device`` and
    never written into; None draws them from ``cfg.seed``.  ``telemetry``
    (or ``cfg.telemetry`` / ``trace_out`` / ``telemetry_out``) turns on
    the span tracer and the selector audit; they never feed back into a
    decision, so losses, plans, hit history and ``n_traces`` are the same
    with them on or off.

    ``cfg.retry_max > 0`` retries a batch's build on transient failures
    (the module docstring), and ``fault_plan`` (a ``FaultPlan``) injects
    its faults: ``on_built`` after each sampler build (inside the retried
    unit, before the skeleton, so an aborted attempt never reaches the
    SkeletonCache or the PlanCache) and ``on_committed`` after each
    commit.  A plan with ``kernel_faults`` raises
    (:func:`refuse_unported`)."""
    if cfg.model not in MINIBATCH_MODELS:
        raise ValueError(f"mini-batch training supports gcn/gin/sage, "
                         f"not {cfg.model!r}")
    refuse_unported(fault_plan)
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

    ckpt = (ckpt_mod.CheckpointManager(cfg.checkpoint_dir,
                                       keep=cfg.checkpoint_keep,
                                       telemetry=tele)
            if cfg.checkpoint_dir and cfg.checkpoint_every > 0 else None)
    retry_policy = (ft.RetryPolicy(max_retries=cfg.retry_max,
                                   base_delay_s=cfg.retry_base_delay_s,
                                   tracer=tracer if tele.enabled else None)
                    if cfg.retry_max > 0 else None)
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
    # plan.layers -> its KernelPlan at first use: checkpoints carry the
    # plans in step-function order, so a resumed run reseeds that order
    first_plan: dict[tuple, KernelPlan] = {}
    # step-function creation and the shape records the finish stage makes
    step_lock = threading.RLock()

    def get_step_fn(plan):
        fn = step_fns.get(plan.layers)
        if fn is None:
            with step_lock:
                fn = step_fns.get(plan.layers)
                if fn is None:
                    first_plan[plan.layers] = plan
                    fn = step_fns[plan.layers] = make_sampled_step(
                        cfg, plan, counters)
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

    def build_batch(batch, sample_s: float) -> _InFlight:
        """Racing stage: the partition pass into a skeleton (through the
        SkeletonCache), at the bell slack of the moment under the budget-K
        autotuner (the ordered stage rebuilds it if the ladder stepped
        while the batch was in flight), plus the fixed selector's host
        payloads, which take no shared-state decision (deferred to the
        ordered stage under the autotuner)."""
        t0 = time.perf_counter()
        with tracer.span("build", cat="host"):
            slack = cache.bell_slack if cfg.adapt_budget_k else None
            skel, inv_deg = skeleton_for(batch, slack)
            c = _InFlight(batch=batch, skel=skel, inv_deg=inv_deg,
                          slack=slack, times=dict(sample=sample_s))
            if fixed_names is not None and not cfg.adapt_budget_k:
                c.dec = skel.materialize(fixed_names, device=None)
                c.plan = KernelPlan.make(c.dec, fixed_names,
                                         n_layers=cfg.n_layers,
                                         epilogues=epilogues)
        c.times["skeleton"] = time.perf_counter() - t0
        return c

    # resolve-time checkpoint snapshots by batch index, waiting for the
    # consumer to commit that batch's params
    pending_snaps: dict[int, dict] = {}
    snap_lock = threading.Lock()

    def resolve_batch(c: _InFlight, gi: int | None = None) -> _InFlight:
        """Ordered stage: every shared-cache decision, in batch order (the
        pipeline's turnstile; the sync loop is in order anyway): the
        PlanCache lookup (selection on a miss), the budget-K spill
        feedback, the canonical signature, the step function's place in
        first-use order, and, for a training batch ``gi`` that ends a
        checkpoint interval, the snapshot of cache and plans (taken here:
        at the consumer's commit of batch gi the pipeline has resolved
        batches past it)."""
        t0 = time.perf_counter()
        with tracer.span("resolve", cat="host"):
            if cfg.adapt_budget_k:
                slack = cache.bell_slack
                if slack != c.slack:   # the ladder stepped while in flight
                    c.slack = slack
                    c.skel, c.inv_deg = skeleton_for(c.batch, slack)
                    c.dec = c.plan = None
            if fixed_names is not None:
                if c.dec is None:      # adapt_budget_k defers it here
                    c.dec = c.skel.materialize(fixed_names, device=None)
                    c.plan = KernelPlan.make(c.dec, fixed_names,
                                             n_layers=cfg.n_layers,
                                             epilogues=epilogues)
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
            if (ckpt is not None and gi is not None
                    and (gi + 1) % cfg.checkpoint_every == 0):
                with step_lock:
                    plans = [first_plan[k] for k in step_fns]
                    sigs = [sig_of_layers[k] for k in step_fns]
                with snap_lock:
                    pending_snaps[gi] = dict(cache=cache.state_dict(),
                                             plans=plans, sigs=sigs)
        c.times["lookup"] = time.perf_counter() - t0
        return c

    def finish_batch(c: _InFlight, train: bool = True,
                     stager: _Stager | None = None) -> _Prepared:
        """Racing stage: the plan's payloads padded to the budget and, with
        the batch, copied to the device (staged by ``stager`` on a
        pipeline worker); for a training batch, its spill and the step's
        shape record (counted once per plan and caps, under one lock).
        On the card it first makes sure the kernel libraries are loaded,
        so the consumer never waits on nvcc.

        The pipeline's retry policy may re-run this stage from the same
        ``c``, so its state comes last: the host payloads (kept on ``c``,
        a pure function of it) and the spill come first, then the kernel
        libraries, then the staging copy (pinned buffers, the event) and
        the shape record.  Every failure from the libraries on is fatal
        (:func:`_fatal`), so no retry ever follows a staging copy or a
        shape record of a failed attempt."""
        t0 = time.perf_counter()
        with tracer.span("finish", cat="host"):
            keys = plan_payload_keys(c.plan)
            if c.dec is None:
                c.dec = c.skel.materialize(keys, device=None)
            spill = {}
            for sub, ks in zip(c.dec.subgraphs, keys):
                for key in ks & {"bell", "tcgnn_tile"} if train else ():
                    acc = spill.setdefault(key, [0, 0])
                    acc[0] += sub.formats[key][2].nnz
                    acc[1] += sub.stats["nnz"]

            def make(copy=None):
                return step_args(c.batch, c.dec, c.inv_deg, c.plan,
                                 pad_budget, dev, stats=c.sig, copy=copy)

            with _fatal("loading the GNN kernel libraries"):
                if dev.type == "cuda":
                    _build.build_all(_build.GNN_SOURCES)
            with _fatal("staging the batch"):
                ready, staged = None, []
                if stager is not None:
                    args, ready, staged = stager.stage(make)
                else:
                    args = make()
                if train:
                    with step_lock:
                        get_step_fn(c.plan).record.check(args)
        c.times["materialize"] = time.perf_counter() - t0
        return _Prepared(c.batch, c.plan, args, c.hit, c.times, spill,
                         ready, staged)

    def build_stage(ticket) -> _InFlight:
        """The sampler's build of a drawn ticket and the fault plan's hook,
        then :func:`build_batch`: the unit the retry policy re-runs (the
        pipeline's racing work stage).  The hook comes before the
        skeleton, so an aborted attempt never reaches the SkeletonCache or
        the PlanCache."""
        t0 = time.perf_counter()
        with tracer.span("sample", cat="host", index=ticket.index):
            batch = sampler.build(ticket)
            if fault_plan is not None:
                batch = fault_plan.on_built(ticket.index, batch)
        return build_batch(batch, time.perf_counter() - t0)

    losses, hit_history, plan_history = [], [], []
    spill: dict = {}
    dropped = 0
    start_i = 0
    if cfg.resume_from:
        mgr = (ckpt if ckpt is not None
               and cfg.resume_from == cfg.checkpoint_dir
               else ckpt_mod.CheckpointManager(cfg.resume_from,
                                               keep=cfg.checkpoint_keep))
        step_no = mgr.latest_valid_step()
        if step_no is None:
            # crashed before the first checkpoint landed: a fresh run is
            # the right resume
            warnings.warn(f"resume_from={cfg.resume_from!r} has no valid "
                          f"checkpoint; starting fresh", stacklevel=2)
        else:
            state, _ = mgr.restore(dict(params=params, opt=opt),
                                   step=step_no, device=dev)
            params, opt = state["params"], state["opt"]
            aux = mgr.load_aux(step_no)
            start_i = aux["cursor"]
            # batch i is a pure function of (seed, i): replaying the draw
            # count re-aligns the sampler's streams
            sampler.fast_forward(start_i)
            cache.load_state_dict(aux["cache"])
            losses = list(aux["losses"])
            hit_history = list(aux["hit_history"])
            plan_history = list(aux["plan_history"])
            spill = {k: list(v) for k, v in aux["spill"].items()}
            dropped = aux["dropped"]
            # step functions in the checkpointed first-use order, so the
            # reported plans match the uninterrupted run's (their shape
            # records start anew, so n_traces counts this run's records)
            for plan, sig in zip(aux["plans"], aux["sigs"]):
                sig_of_layers[plan.layers] = sig
                get_step_fn(plan)
            f_resumed.set(start_i)
            _log.info("resumed from %s at batch %d", cfg.resume_from,
                      start_i)
    n_new = max(steps - start_i, 0)
    times = {k: [] for k in ("sample", "skeleton", "lookup", "materialize",
                             "step", "iter")}

    def consume(i: int, item: _Prepared) -> None:
        """Commit one batch on the calling thread: its step, its records
        and, at the end of a checkpoint interval, the checkpoint."""
        nonlocal params, opt, dropped
        gi = start_i + i
        dropped += item.batch.meta.get("dropped_edges", 0)
        hit_history.append(item.hit)
        plan_history.append(item.plan.layers)
        for k, v in item.times.items():
            times[k].append(v)
        for k, (spilled, edges) in item.spill.items():
            acc = spill.setdefault(k, [0, 0])
            acc[0] += spilled
            acc[1] += edges
        if item.ready is not None:
            _Stager.hand_over(item.ready, item.staged)
        t0 = time.perf_counter()
        with tracer.span("device_step", cat="device", index=gi,
                         hit=item.hit):
            params, opt, loss, finite = get_step_fn(item.plan)(
                params, opt, *item.args, check=False)
            loss_f = float(loss)
        dt = time.perf_counter() - t0
        times["step"].append(dt)
        tele.audit.observe_step(item.plan.layers, dt)
        if not finite:
            fault["nonfinite_skips"].inc()
        losses.append(loss_f)
        if ckpt is not None:
            with snap_lock:
                snap = pending_snaps.pop(gi, None)
            if snap is not None:
                # the consumer's params and Adam state with the resolve
                # stage's cache snapshot: the state a fresh run holds
                # after batch gi with nothing in flight
                aux = dict(cursor=gi + 1, losses=list(losses),
                           hit_history=list(hit_history),
                           plan_history=list(plan_history),
                           spill={k: list(v) for k, v in spill.items()},
                           dropped=dropped, **snap)
                ckpt.save(gi + 1, dict(params=params, opt=opt), aux=aux)
                fault["checkpoints"].inc()
        if fault_plan is not None:
            fault_plan.on_committed(gi)
        if i % 10 == 0 and _log.isEnabledFor(logging.INFO):
            cs = cache.stats
            _log.info(f"batch {gi:4d} loss {loss_f:.4f} "
                      f"cache_hit={item.hit} plan={item.plan.layers[0]} "
                      f"cache[h={cs['hits']} nh={cs['near_hits']} "
                      f"m={cs['misses']} ev={cs['evictions']} "
                      f"pr={cs['probes']} rate={cs['hit_rate']:.2f}]")

    pipe_stats = None
    t_loop0 = time.perf_counter()
    try:
        if cfg.prefetch_depth > 0:
            stager = _Stager(dev) if dev.type == "cuda" else None
            pipe = BatchPipeline(
                sampler.draw, lambda idx, ticket: build_stage(ticket),
                n_items=n_new,
                resolve_fn=lambda idx, c: resolve_batch(c, start_i + idx),
                finish_fn=lambda idx, c: finish_batch(c, stager=stager),
                prefetch_depth=cfg.prefetch_depth,
                workers=cfg.pipeline_workers,
                name=f"{cfg.sampler}-{cfg.model}", retry=retry_policy,
                retryable=ft.default_transient, telemetry=tele)
            try:
                for i in range(n_new):
                    it0 = time.perf_counter()
                    consume(i, pipe.get())
                    times["iter"].append(time.perf_counter() - it0)
            finally:
                pipe_stats = pipe.stats
                pipe.close()
            fault["retries"].inc(pipe_stats["retries"])
        else:
            def on_retry(attempt):
                fault["retries"].inc()

            for i in range(n_new):
                it0 = time.perf_counter()
                ticket = sampler.draw()
                if retry_policy is None:
                    c = build_stage(ticket)
                else:
                    c = retry_policy.run(build_stage, ticket,
                                         on_retry=on_retry,
                                         retryable=ft.default_transient)
                consume(i, finish_batch(resolve_batch(c, start_i + i)))
                times["iter"].append(time.perf_counter() - it0)
    finally:
        if ckpt is not None:
            ckpt.wait()     # a crash still lands the last save
    loop_s = time.perf_counter() - t_loop0
    if pipe_stats is not None:
        # the step's share of the steady-state iteration: 100 % = the
        # host prepare fully hidden (the first iteration, which waits for
        # the first batch with nothing to overlap, is left out)
        busy = float(np.sum(times["step"][1:]))
        steady = float(np.sum(times["iter"][1:]))
        pipe_stats.update(
            loop_seconds=loop_s,
            efficiency_pct=100.0 * busy / max(steady, 1e-12),
            retries=fault["retries"].value,
            quarantined=fault["quarantined"].value,
            nonfinite_skips=fault["nonfinite_skips"].value)
        _log.info("pipeline: depth=%d workers=%d ready_mean=%.1f "
                  "wait_full=%.1fms wait_empty=%.1fms efficiency=%.0f%%",
                  pipe_stats["depth"], pipe_stats["workers"],
                  pipe_stats["ready_mean"],
                  pipe_stats["wait_full_s"] * 1e3,
                  pipe_stats["wait_empty_s"] * 1e3,
                  pipe_stats["efficiency_pct"])

    # the training steady state, before the eval batches' own lookups
    cache_stats = dict(cache.stats)
    plans_trained = list(step_fns)

    # masked accuracy over a few fresh batches
    correct = total = 0
    eval_plans = []
    for _ in range(eval_batches):
        c = resolve_batch(build_batch(sampler.sample(), 0.0))
        eval_plans.append(c.plan.layers)
        dec, x, labels, tm, _ = finish_batch(c, train=False).args
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
        pipeline=pipe_stats, dropped_edges=dropped, plan_cache=cache,
        skeleton_hits=skel_cache.hits if skel_cache else 0,
        skeleton_misses=skel_cache.misses if skel_cache else 0,
        faults=faults, telemetry=tele.summary(), params=params,
        plan_history=plan_history, eval_plans=eval_plans, spill=spill,
        stage_seconds={k: med(times[k]) for k in ("sample", "skeleton",
                                                  "lookup", "materialize")})
