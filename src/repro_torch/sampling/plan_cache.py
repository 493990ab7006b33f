"""PlanCache: amortized per-batch kernel selection + fixed-shape payloads.

Counterpart of ``repro/sampling/plan_cache.py``: the same signatures,
lookups, counters, evictions and slack ladder, so both packages commit
the same plans batch by batch under one cost model.  The port's payloads
stay host numpy through :func:`fix_shapes`; the mini-batch loop then
places the padded decomposition on the device that trains, and a probe
times its candidates on ``PlanCache(device=...)``.

Every sampled batch is a fresh graph, so the paper's dynamic selection
(§4) would re-run per step.  Two observations make it amortizable:

* Batches drawn from one sampler are *statistically* alike: quantizing
  each tier's density statistics (log2-bucketed nnz, binned block-row
  occupancy) collapses the stream of per-batch decompositions onto a
  handful of :func:`density_signature` keys.  :class:`PlanCache` memoizes
  the cost-model-selected :class:`KernelPlan` per key — selection runs on
  a miss, steady-state steps reuse the committed plan (LRU-bounded).

* The train step of a plan must see one set of shapes (one trace in the
  reference, one record in the port's step): :func:`fix_shapes` pads
  every COO/CSR payload to the sampler's edge budget (zero-valued edges
  in the last row keep the math and the sorted-segment invariant intact)
  and scrubs the per-batch ``stats`` dicts.  Only budget-paddable formats are materialized per batch —
  ``MB_KERNELS`` — which is why the mini-batch hot loop partitions each
  batch once into a ``decompose_skeleton(keep_empty_buckets=True,
  edge_budget=...)`` and materializes payloads from it (the full
  ``MB_KERNELS`` candidate set only when selection runs on a miss, the
  committed plan's per-tier payload keys on a hit).
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import threading
import warnings
import zlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import formats, selector as sel_mod
from repro_torch.core.decompose import Decomposed
from repro_torch.core.plan import KernelPlan
from repro_torch.kernels import tcgnn_tile
from repro_torch.kernels.registry import REGISTRY
from repro_torch.obs import Telemetry

# the cache's published counters; each is a registry Counter surfaced as a
# same-named attribute (plan_cache.<name>) so `self.hits += 1` style code
# and the stats view read/write one system of record
_COUNTERS = ("hits", "near_hits", "misses", "evictions", "probes",
             "quarantined", "slack_changes")


def _counter_attr(key: str):
    """Attribute <-> registry-counter bridge: reads return the counter's
    value, writes (including ``+=``) land in the counter.  Lost-update
    safety comes from the cache's own RLock, which every mutating path
    already holds."""
    def fget(self):
        return self._counters[key].value

    def fset(self, v):
        self._counters[key].set(v)

    return property(fget, fset)

# Kernels admitted to the mini-batch path.  Membership rule: a kernel is
# admissible iff its payload has *fixed shapes at the edge budget* —
# every array dim a function of (budget, node budget, block size) alone,
# nothing data-dependent.  BlockDiag is (n/B, B, B) for any batch, COO/CSR
# pad to the edge budget, and blocked-ELL qualifies through its
# budget-padded variant: decomposing with an ``edge_budget`` caps the
# stored-block count at K = bell_budget_k(budget, n_pad, B), pads block
# payloads to that cap with masked zero-blocks, and spills overflow edges
# to an in-payload COO tier (padded to the budget like any other COO).
# ELL stays out (max-degree width is data-dependent).  The condensed-tile
# kernel (tcgnn_tile) qualifies the same way bell does: its column cap
# C = tcgnn_budget_c(budget, n_pad, B) is a function of the budget alone,
# block rows keep their densest C columns, and overflow edges spill to the
# in-payload COO (padded to the budget like any other COO).  Fused kernels
# alias their unfused payload, so transform-first layers keep them — GCN
# natively, GIN/SAGE through the epilogue rewrite (core.epilogue); the
# fused CSR path (per-edge gathered transform) rides the CSR payload.
MB_KERNELS = ("block_diag", "block_diag_fused", "coo", "csr", "csr_fused",
              "bell", "bell_fused", "tcgnn_tile", "tcgnn_tile_fused")


# ---------------------------------------------------------------------------
# Fixed-shape padding
# ---------------------------------------------------------------------------

def _padded(arr, budget: int, fill) -> np.ndarray:
    """Host-side pad-to-budget (numpy, before the one copy to the device).
    Each region is written exactly once (empty + copy + fill-tail, not
    full + copy): this runs per payload array per batch on the hot
    path."""
    a = formats._np(arr)
    out = np.empty((budget,), a.dtype)
    out[: len(a)] = a
    out[len(a):] = fill
    return out


def _pad_coo(coo: formats.COO, budget: int) -> formats.COO:
    nnz = int(coo.rows.shape[0])
    if nnz > budget:
        raise ValueError(f"COO nnz {nnz} exceeds edge budget {budget}")
    if nnz == budget:
        return coo
    # padded edges live in the last row (keeps rows sorted for the cheap
    # segment_sum mode) with val 0 (keeps the sum exact)
    return formats.COO(coo.n_rows, coo.n_cols,
                       _padded(coo.rows, budget, coo.n_rows - 1),
                       _padded(coo.cols, budget, 0),
                       _padded(coo.vals, budget, 0.0))


def _pad_csr(csr: formats.CSR, budget: int) -> formats.CSR:
    nnz = int(csr.indices.shape[0])
    if nnz > budget:
        raise ValueError(f"CSR nnz {nnz} exceeds edge budget {budget}")
    if nnz == budget:
        return csr
    # bump only the terminal pointer: the pad entries land in the last
    # row's segment, where their zero vals vanish
    indptr = formats._np(csr.indptr).copy()
    indptr[-1] = budget
    return formats.CSR(csr.n_rows, csr.n_cols, indptr,
                       _padded(csr.indices, budget, 0),
                       _padded(csr.vals, budget, 0.0))


def _pad_payload(name: str, payload, budget: int):
    if isinstance(payload, formats.COO):
        return _pad_coo(payload, budget)
    if isinstance(payload, formats.CSR):
        return _pad_csr(payload, budget)
    if isinstance(payload, formats.BlockDiag):
        return payload                      # shape fixed by (n_pad, B)
    if (isinstance(payload, tuple) and len(payload) == 3
            and all(isinstance(b, formats.BlockELL) and b.budgeted
                    for b in payload[:2])):
        # budget-padded blocked-ELL (bell, bell_t, spill): the bells are
        # already shape-fixed by construction (K from the edge budget),
        # only the spill COO needs the budget pad
        return payload[:2] + (_pad_coo(payload[2], budget),)
    if (isinstance(payload, tuple) and len(payload) == 3
            and all(isinstance(b, tcgnn_tile.TcgnnTile) and b.budgeted
                    for b in payload[:2])):
        # budget-capped condensed tiles (tc, tc_t, spill): C is a function
        # of the edge budget (tcgnn_budget_c), only the spill COO pads
        return payload[:2] + (_pad_coo(payload[2], budget),)
    raise TypeError(
        f"payload {name!r} ({type(payload).__name__}) has no fixed-shape "
        f"padding; mini-batch decomposition must use kernels={MB_KERNELS} "
        f"and pass the sampler's edge_budget to decompose (budget-capped "
        f"blocked-ELL only)")


def fix_shapes(dec: Decomposed, edge_budget: int,
               keep: frozenset | set | None = None,
               stats: tuple | None = None) -> Decomposed:
    """Pad every payload to the edge budget and scrub per-batch stats.

    Across batches from one sampler the result always has the same
    structure, the same static metadata, and the same array shapes and
    dtypes: what the port's step records per plan and checks.

    ``keep`` optionally restricts to the payload keys a committed plan
    dispatches (see :func:`plan_payload_keys`) so unused candidate formats
    are not padded and copied to the device every step: either
    one set applied to every subgraph, or a per-subgraph sequence of sets
    (the plan_payload_keys form — tier i keeps only what some layer
    dispatches *on tier i*).  It must be derived from the plan alone, so
    batches sharing a step function keep one treedef.

    ``stats`` optionally replaces the scrub with a *hashable* summary —
    the quantized :func:`density_signature` bins of the plan that the step
    was built for (canonical per plan, the same value for every batch
    sharing a step function).  The per-subgraph dicts are still scrubbed;
    their bins live inside the signature tuple.
    """
    if isinstance(keep, (tuple, list)):
        if len(keep) != len(dec.subgraphs):
            raise ValueError(
                f"per-subgraph keep has {len(keep)} entries for "
                f"{len(dec.subgraphs)} subgraphs (one set per subgraph; "
                f"wrap a single shared key set in frozenset, not tuple)")
        if any(isinstance(k, str) for k in keep):
            raise TypeError(
                "keep entries must be collections of payload keys, not "
                "strings (a tuple of names would filter by substring)")
        keeps = keep
    else:
        keeps = [keep] * len(dec.subgraphs)
    subs = tuple(
        dataclasses.replace(
            s, stats=None,
            formats={k: _pad_payload(k, p, edge_budget)
                     for k, p in s.formats.items()
                     if ki is None or k in ki})
        for s, ki in zip(dec.subgraphs, keeps))
    return dataclasses.replace(dec, subgraphs=subs, stats=stats)


def plan_payload_keys(plan) -> tuple[frozenset, ...]:
    """Per-subgraph payload keys a KernelPlan actually dispatches (fused
    kernels alias their unfused payload) — the ``keep`` sets for
    :func:`fix_shapes` and the per-tier kernel lists for
    ``DecomposeSkeleton.materialize``.  Tier i's set covers only the
    kernels some layer assigns to tier i, so a format another tier picked
    is neither built nor padded nor shipped for this one."""
    return tuple(
        frozenset(REGISTRY.get(layer[i]).payload_key for layer in plan.layers)
        for i in range(len(plan.subgraph_names)))


# ---------------------------------------------------------------------------
# Density signature + cache
# ---------------------------------------------------------------------------

def density_signature(dec, nnz_log2_step: float = 2.0,
                      occ_bins: int = 2) -> tuple:
    """Quantized per-tier density histogram — the PlanCache key.  ``dec``
    is anything exposing ``n_pad`` / ``block_size`` / ``subgraphs`` with
    per-tier ``kind`` + ``stats`` (a Decomposed or a DecomposeSkeleton).

    Per tier: (kind, round(log2(nnz+1)/step), ceil(occupancy * bins),
    ceil(col_occupancy * bins)).  The fourth element bins the tier's
    column occupancy (distinct condensed columns per edge —
    decompose._tier_stats) so tile-condensability is visible to lookup:
    two batches alike in nnz and block-row occupancy but unlike in
    condensability select different condensed-tile (tcgnn) costs and must
    not share a plan.  Decompositions predating the stat bin to 0, a value
    a real tier never produces (any edge gives col_occupancy > 0), so old
    persisted signatures cannot alias new ones.
    Coarse on purpose: batches from one sampler differ by sampling noise,
    not by regime, and the cost-model argmin is flat across a density
    decade — finer keys only manufacture misses (hit rate is the product
    being bought; tighten the steps if a workload's crossovers are sharp).
    """
    tiers = tuple(
        (s.kind,
         int(round(math.log2(s.stats["nnz"] + 1) / nnz_log2_step)),
         int(math.ceil(s.stats.get("brow_occupancy", 0.0) * occ_bins)),
         int(math.ceil(s.stats.get("col_occupancy", 0.0) * occ_bins)))
        for s in dec.subgraphs)
    return (dec.n_pad, dec.block_size, tiers)


class PlanCache:
    """signature -> KernelPlan memo with cost-model selection on miss.

    ``width_pairs`` are the per-layer ``(in_dim, agg_dim)`` pairs from
    :func:`repro.core.gnn.agg_width_pairs` (ints accepted, meaning no
    transform-first fusion); they are fixed per cache instance, so they
    are part of the cache's identity rather than of each key.

    Lookup is two-stage.  The quantized signature is the exact key; on a
    key miss, cached *anchors* (the raw per-tier stats that minted each
    entry) are scanned for a batch within half a quantization cell on
    every tier — batches straddling a cell boundary flap between two
    signatures forever, and without this they would re-run selection on
    every flap.  A near-match reuses the anchor's plan and aliases the
    new signature to it, so either stage skips selection (both count
    toward ``hit_rate``); only a genuine miss selects.

    Thread safety (the async pipeline's contract): every stateful entry
    point — ``lookup`` / ``plan_for`` / ``observe_bell`` / ``stats`` —
    holds one re-entrant lock, so concurrent resolution is *safe*:
    ``plan_for`` is atomic (lookup + select + store under the lock), and
    two workers racing the same fresh signature cost exactly one miss —
    the loser blocks, then hits.  Atomicity alone is not *deterministic*,
    though: cross-signature ordering still matters, because a later batch
    can hit (or near-hit) an entry an earlier batch minted, and the
    near-hit anchor scan and LRU order are insertion-order dependent — so
    the pipeline additionally serializes all lookup/plan_for/observe_bell
    calls in batch-index order (``BatchPipeline``'s resolve turnstile),
    which makes every counter, alias, and eviction bit-identical to
    single-threaded training.  Probes serialize behind the same lock, one
    wall-clock measurement at a time, so a probe's timing is never
    polluted by another probe's device work (with the pipeline the
    consumer's step can still overlap a probe; probing defaults off in
    pipeline mode — ``cfg.probe_every = 0``).
    """

    def __init__(self, width_pairs, dtype=np.float32,
                 hw: sel_mod.HwModel | None = None,
                 nnz_log2_step: float = 2.0, occ_bins: int = 2,
                 max_entries: int = 128, probe_every: int = 0,
                 probe_iters: int = 2, edge_budget: int | None = None,
                 epilogues=None, probe_k_max: int = 4,
                 probe_budget_s: float | None = 2.0,
                 adapt_budget_k: bool = False,
                 bell_slack: float = 2.0, spill_target: float = 0.05,
                 slack_ladder: tuple = (1.0, 1.5, 2.0, 3.0, 4.0),
                 spill_min_obs: int = 8,
                 max_slack_changes: int | None = None,
                 telemetry: Telemetry | None = None,
                 device: str | torch.device = DEFAULT_DEVICE,
                 fixed_kernels: tuple | None = None):
        # telemetry first: the counter attributes below are properties
        # over registry counters, so the registry must exist before any
        # `self.hits = 0` style assignment runs
        self.tele = telemetry if telemetry is not None else Telemetry()
        self._counters = {k: self.tele.metrics.counter(f"plan_cache.{k}")
                          for k in _COUNTERS}
        self.pairs = [(None, w) if isinstance(w, int) else tuple(w)
                      for w in width_pairs]
        # per-layer EpilogueSpecs aligned with the pairs: selection and
        # probing price the dense epilogue honestly (free transform for
        # GIN's MLP, flat self-matmul for SAGE's dual weights)
        self.epilogues = (tuple(epilogues) if epilogues is not None
                          else (None,) * len(self.pairs))
        self.dtype = dtype
        # the device a probe times its candidates on (the one that trains)
        # and whose cost model prices them by default
        self.device = resolve_device(device)
        self.hw = hw or sel_mod.default_hw(self.device)
        self.nnz_log2_step = nnz_log2_step
        self.occ_bins = occ_bins
        self.max_entries = max_entries
        # feedback probing: on every ``probe_every``-th miss, time the cost
        # model's top-2 candidates per (layer, subgraph) on the device and
        # pin the measured winner in the cached entry (0 = cost model only)
        self.probe_every = probe_every
        self.probe_iters = probe_iters
        # port only: one kernel per tier committed on every miss in place
        # of selection and probing (a fixed-selector model served on the
        # plan it trained on); None = the reference's selection
        self.fixed_kernels = (tuple(fixed_kernels)
                              if fixed_kernels is not None else None)
        # adaptive probe widening: the probe widens past top-2 (up to
        # probe_k_max) when the modeled margin between candidates sits
        # inside the model's observed relative-error band, accumulated
        # from this cache's own probe measurements; probe_budget_s caps
        # one miss's probe wall time, compiles included
        self.probe_k_max = probe_k_max
        self.probe_budget_s = probe_budget_s
        self._probe_errs: list[tuple] = []      # (modeled_s, measured_s)
        # the sampler's padded edge-slot count: probes time candidates on
        # payloads padded to it, because that is what the step executes
        self.edge_budget = edge_budget
        # budget-K autotuning: committed capped-bell plans report their
        # spill nnz + slot utilization per signature; once enough batches
        # are observed the blocked-ELL budget slack steps along the ladder
        # (more slack when spill exceeds ``spill_target`` of the tier's
        # edges, less when nothing spills and most padded slots are waste).
        # The current slack keys the signature, so plans selected under
        # one K never serve another K's payload shapes.
        self.adapt_budget_k = adapt_budget_k
        self.spill_target = spill_target
        self.spill_min_obs = spill_min_obs
        self._slack_ladder = tuple(sorted(set(slack_ladder) | {bell_slack}))
        self._bell_slack = bell_slack
        self._spill_by_sig: dict[tuple, list] = {}   # sig -> [spill, stored]
        self._spill_window: list[tuple] = []    # (spill_frac, slot_util)
        self.slack_changes = 0
        # every slack step changes the capped payload shapes (one more step
        # record, a retrace in the reference); the cap bounds the steps per
        # run (None = unbounded)
        self.max_slack_changes = max_slack_changes
        # one re-entrant lock over all mutable state: pipeline workers
        # resolve plans concurrently, probes serialize behind it
        self._lock = threading.RLock()
        # signature -> (plan, anchor); anchor = raw (kind, log2 nnz, occ)
        # per tier of the decomposition that minted (or aliased) the entry
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        # kernel quarantine: signature -> set of kernel names whose compile
        # or execution failed under that signature's payload shapes.  A
        # quarantined (kernel, signature) pair is struck from selection and
        # from near-hit aliasing, so a broken hand kernel degrades the plan
        # to the next-best candidate instead of killing the run (the torch
        # ``coo`` path is never quarantined — the floor always selects).
        # This port keeps the bookkeeping only: nothing calls it on a
        # failure yet.
        self._quarantine: dict[tuple, set] = {}
        self.hits = 0
        self.near_hits = 0
        self.misses = 0
        self.evictions = 0
        self.probes = 0
        self.quarantined = 0    # (kernel, signature) pairs quarantined

    # registry-backed counters (see _counter_attr): the same numbers the
    # stats view reports are what the run's metrics snapshot exports
    hits = _counter_attr("hits")
    near_hits = _counter_attr("near_hits")
    misses = _counter_attr("misses")
    evictions = _counter_attr("evictions")
    probes = _counter_attr("probes")
    quarantined = _counter_attr("quarantined")
    slack_changes = _counter_attr("slack_changes")

    def attach_telemetry(self, telemetry: Telemetry) -> None:
        """Re-home this cache's instruments into a run's shared Telemetry
        (the driver calls this when handed a pre-built cache): audit and
        tracer swap to the run's, and the counters migrate into the run's
        registry carrying their current values, so the metrics snapshot
        and the legacy stats view stay one system of record."""
        with self._lock:
            self.tele = telemetry
            moved = {}
            for key, c in self._counters.items():
                nc = telemetry.metrics.counter(c.name)
                if nc is not c:
                    nc.set(c.value)
                moved[key] = nc
            self._counters = moved

    def _dec_slack(self, dec) -> float:
        """The slack this decomposition was *built* with (baked into its
        tier stats by ``decompose_skeleton(bell_slack=...)``), falling back
        to the cache's current slack for decompositions that never threaded
        one.  Reading the built value keeps signature/anchor a pure
        function of the batch: a pipeline worker stepping the ladder
        mid-flight can't shear another batch's cache key away from the
        payload shapes it actually carries."""
        for s in dec.subgraphs:
            st = getattr(s, "stats", None)
            if st and "bell_slack" in st:
                return float(st["bell_slack"])
        return self._bell_slack

    def signature(self, dec) -> tuple:
        sig = density_signature(dec, self.nnz_log2_step, self.occ_bins)
        if self.adapt_budget_k:
            # the slack determines the capped-bell K and with it every bell
            # candidate's cost and payload shape: fold it into the key so a
            # slack step cleanly re-selects instead of serving stale plans
            sig = sig + (("bell_slack", self._dec_slack(dec)),)
        return sig

    # -- budget-K autotuning from observed spill (ROADMAP) ------------------

    @property
    def bell_slack(self) -> float:
        """Slack factor for ``formats.bell_budget_k`` — callers thread it
        into ``decompose_skeleton(bell_slack=...)`` so per-batch capped
        builds use the adapted K."""
        with self._lock:
            return self._bell_slack

    def observe_bell(self, dec) -> None:
        """Record spill/utilization of every committed budget-capped bell
        payload in ``dec`` and step the slack when the evidence is in.

        Called by the mini-batch loop after materializing a committed
        plan's payloads, so only plans that actually dispatch bell feed
        the autotuner (a tier the selector routed to COO says nothing
        about the cap)."""
        if not self.adapt_budget_k:
            return
        with self._lock:
            self._observe_bell_locked(dec)

    def _observe_bell_locked(self, dec) -> None:
        for sub in dec.subgraphs:
            p = sub.formats.get("bell")
            if not (isinstance(p, tuple) and len(p) == 3
                    and getattr(p[0], "budgeted", False)):
                continue
            spill = int(p[2].nnz)
            stored = int((sub.stats or {}).get("nnz", 0)) - spill
            acc = self._spill_by_sig.setdefault(
                (sub.name, p[0].max_blocks), [0, 0])
            acc[0] += spill
            acc[1] += max(stored, 0)
            spill_frac = spill / max(spill + stored, 1)
            # fraction of padded block slots holding a real block: low
            # utilization with zero spill means the cap is pure waste
            slot_util = (float(formats._np(p[0].n_valid).sum())
                         / max(p[0].n_brow * p[0].max_blocks, 1))
            self._spill_window.append((spill_frac, slot_util))
        self._maybe_step_slack()

    def _maybe_step_slack(self) -> None:
        if len(self._spill_window) < self.spill_min_obs:
            return
        if (self.max_slack_changes is not None
                and self.slack_changes >= self.max_slack_changes):
            # step budget exhausted: hold the ladder where it is (each step
            # re-shapes the capped payloads)
            self._spill_window.clear()
            return
        window = self._spill_window[-self.spill_min_obs:]
        spill = float(np.mean([s for s, _ in window]))
        util = float(np.mean([u for _, u in window]))
        ladder = self._slack_ladder
        i = ladder.index(self._bell_slack)
        nxt = None
        if spill > self.spill_target and i + 1 < len(ladder):
            nxt = ladder[i + 1]         # hub-heavy: grow K, spill less
        elif spill == 0.0 and util < 0.25 and i > 0:
            nxt = ladder[i - 1]         # nothing spills, slots mostly pad
        if nxt is not None:
            self._bell_slack = nxt
            self.slack_changes += 1
            self._spill_window.clear()

    def _anchor(self, dec) -> tuple:
        """(minting slack, raw per-tier stats).  The slack rides along so
        near-hit aliasing never bridges a budget-K slack step — a slack
        change alters every bell candidate's K (cost and payload shape),
        and the whole point of folding it into the signature is to force
        re-selection rather than serve plans priced for the old cap."""
        tiers = tuple((s.kind, math.log2(s.stats["nnz"] + 1),
                       s.stats.get("brow_occupancy", 0.0),
                       s.stats.get("col_occupancy", 0.0))
                      for s in dec.subgraphs)
        return (self._dec_slack(dec) if self.adapt_budget_k else None, tiers)

    def _near(self, a: tuple, b: tuple) -> bool:
        """Same minting slack, within half a quantization cell per tier.

        Length-tolerant per tier: anchors minted before the column-
        occupancy stat carry 3-element tier tuples (persisted snapshots —
        state_dict/save round-trip them verbatim), and a legacy anchor
        compares on the stats it has, so pre-upgrade entries keep serving
        their plans instead of going permanently cold."""
        if a[0] != b[0] or len(a[1]) != len(b[1]):
            return False
        for ta, tb in zip(a[1], b[1]):
            if ta[0] != tb[0]:
                return False
            if abs(ta[1] - tb[1]) > self.nnz_log2_step / 2:
                return False
            if abs(ta[2] - tb[2]) > 0.5 / self.occ_bins:
                return False
            if (len(ta) > 3 and len(tb) > 3
                    and abs(ta[3] - tb[3]) > 0.5 / self.occ_bins):
                return False
        return True

    def select(self, dec: Decomposed,
               exclude: frozenset | None = None) -> KernelPlan:
        """Uncached cost-model selection (what every step would pay
        without the cache — the benchmark's 'uncached' row).  ``exclude``
        defaults to the quarantine set for the batch's signature."""
        if exclude is None:
            with self._lock:
                exclude = frozenset(
                    self._quarantine.get(self.signature(dec), ()))
        layers = [sel_mod.select_by_cost_model(dec, fout, self.dtype,
                                               hw=self.hw, in_dim=fin,
                                               epilogue=ep, exclude=exclude)
                  for (fin, fout), ep in zip(self.pairs, self.epilogues)]
        return KernelPlan.make(dec, layers, epilogues=self.epilogues)

    # -- kernel quarantine (fault tolerance; train/gnn_steps.py) ------------

    @staticmethod
    def _plan_kernels(plan: KernelPlan) -> set:
        return {k for layer in plan.layers for k in layer}

    def quarantine(self, sig: tuple, kernels) -> set:
        """Strike ``kernels`` from signature ``sig``'s candidate set and
        purge any cached entry dispatching them, so the next lookup
        re-selects around the failure.  ``coo`` (the torch index_add_ floor
        that every subgraph kind admits) is never quarantined — graceful
        degradation must terminate at a plan that always runs.  Returns
        the names newly quarantined."""
        with self._lock:
            q = self._quarantine.setdefault(sig, set())
            fresh = {str(k) for k in kernels} - {"coo"} - q
            q.update(fresh)
            self.quarantined += len(fresh)
            if fresh:
                self.tele.audit.quarantine(sig=sig, kernels=fresh)
                self.tele.tracer.instant("quarantine", cat="cache",
                                         kernels=sorted(fresh))
            if fresh and sig in self._entries:
                plan, _ = self._entries[sig]
                if self._plan_kernels(plan) & q:
                    del self._entries[sig]
            return fresh

    def quarantined_for(self, sig: tuple) -> frozenset:
        with self._lock:
            return frozenset(self._quarantine.get(sig, ()))

    # -- checkpoint state (distributed.checkpoint aux payload) --------------

    def state_dict(self) -> dict:
        """Picklable snapshot of every piece of mutable state the resume
        contract covers: entries (plans + anchors, in LRU order), all
        counters, the probe error band, the budget-K ladder position and
        its evidence windows, and the quarantine map.  Restoring this via
        :meth:`load_state_dict` and replaying the remaining batches is
        bit-identical to never having stopped (signatures, plans, and
        anchors are plain tuples/dataclasses of primitives)."""
        with self._lock:
            return dict(
                entries=[(sig, plan, anchor)
                         for sig, (plan, anchor) in self._entries.items()],
                hits=self.hits, near_hits=self.near_hits,
                misses=self.misses, evictions=self.evictions,
                probes=self.probes, quarantined=self.quarantined,
                quarantine={sig: sorted(ks)
                            for sig, ks in self._quarantine.items()},
                probe_errs=list(self._probe_errs),
                bell_slack=self._bell_slack,
                slack_changes=self.slack_changes,
                spill_by_sig=[(k, list(v))
                              for k, v in self._spill_by_sig.items()],
                spill_window=list(self._spill_window))

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            self._entries = OrderedDict(
                (sig, (plan, anchor))
                for sig, plan, anchor in state["entries"])
            self.hits = state["hits"]
            self.near_hits = state["near_hits"]
            self.misses = state["misses"]
            self.evictions = state["evictions"]
            self.probes = state["probes"]
            self.quarantined = state["quarantined"]
            self._quarantine = {sig: set(ks)
                                for sig, ks in state["quarantine"].items()}
            self._probe_errs = [tuple(e) for e in state["probe_errs"]]
            self._bell_slack = state["bell_slack"]
            self.slack_changes = state["slack_changes"]
            self._spill_by_sig = {k: list(v)
                                  for k, v in state["spill_by_sig"]}
            self._spill_window = [tuple(w) for w in state["spill_window"]]

    # -- disk persistence (a later process's warm start) -----------------

    _SAVE_MAGIC = b"PLANCACHE1\n"

    def save(self, path: str) -> None:
        """Persist the full :meth:`state_dict` — signatures, committed
        plans, anchors, counters, quarantine, ladder position — so a later
        process can skip selection *and* reproduce this run's plans
        identically.  Write is atomic and crc-checked: serialize to
        ``path + '.tmp'`` with a magic + crc32 header, fsync, then
        ``os.replace`` into place — a crash mid-write never leaves a
        half-written cache where a warm start would find it."""
        with self._lock:
            blob = pickle.dumps(self.state_dict(),
                                protocol=pickle.HIGHEST_PROTOCOL)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(self._SAVE_MAGIC)
            f.write(zlib.crc32(blob).to_bytes(4, "big"))
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load(self, path: str) -> bool:
        """Restore a :meth:`save`d snapshot; returns True on success.
        Any failure — missing file, bad magic, crc mismatch, unpicklable
        payload — warns and leaves the cache untouched (corruption falls
        back to a cold start, never to a crash or a half-loaded cache)."""
        try:
            with open(path, "rb") as f:
                magic = f.read(len(self._SAVE_MAGIC))
                if magic != self._SAVE_MAGIC:
                    raise ValueError(f"bad magic {magic!r}")
                crc = int.from_bytes(f.read(4), "big")
                blob = f.read()
            if zlib.crc32(blob) != crc:
                raise ValueError("crc mismatch")
            state = pickle.loads(blob)
        except FileNotFoundError:
            return False
        except Exception as exc:           # corrupt file: cold start
            warnings.warn(f"PlanCache.load({path!r}): {exc}; "
                          "starting cold", stacklevel=2)
            return False
        self.load_state_dict(state)
        return True

    def _store(self, sig: tuple, plan: KernelPlan, anchor: tuple) -> None:
        self._entries[sig] = (plan, anchor)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1

    def lookup(self, dec) -> KernelPlan | None:
        """Resident plan for the batch's density signature, or None.

        Works on a *stats-only* decomposition (``decompose(kernels=())``)
        or directly on a :class:`~repro.core.decompose.DecomposeSkeleton`:
        both the signature and the anchor read per-tier stats, never
        payloads — so the hot loop checks the cache straight off the
        skeleton and on a hit materializes only the committed plan's
        payloads.  Counts hits/near-hits; a failed lookup is not yet a
        miss (the caller decides whether to select).
        """
        with self._lock:
            sig = self.signature(dec)
            q = self._quarantine.get(sig)
            entry = self._entries.get(sig)
            if entry is not None:
                # a quarantine after the entry was minted purges it in
                # quarantine(); this guards aliased entries stored since
                if q and self._plan_kernels(entry[0]) & q:
                    del self._entries[sig]
                else:
                    self.hits += 1
                    self._entries.move_to_end(sig)
                    return entry[0]
            anchor = self._anchor(dec)
            for plan, a in reversed(self._entries.values()):  # newest first
                if q and self._plan_kernels(plan) & q:
                    continue    # never alias onto a quarantined kernel
                if self._near(anchor, a):
                    self.near_hits += 1
                    self._store(sig, plan, a)   # alias the boundary cell
                    return plan
            return None

    def plan_for(self, dec: Decomposed) -> tuple[KernelPlan, bool]:
        """(plan, hit): memoized plan for the batch's density signature;
        ``hit`` is True whenever selection was skipped.  ``dec`` must
        carry candidate payloads (selection validates against them, and a
        scheduled probe times them) — the two-phase hot path uses
        :meth:`lookup` first instead.  Atomic under the cache lock: two
        pipeline workers racing one fresh signature pay exactly one miss
        (the second blocks, then hits the entry the first minted).  A
        cache made with ``fixed_kernels`` commits that plan on a miss."""
        with self._lock:
            plan = self.lookup(dec)
            if plan is not None:
                return plan, True
            self.misses += 1
            sig = self.signature(dec)
            if self.fixed_kernels is not None:
                plan = KernelPlan.make(dec, self.fixed_kernels,
                                       n_layers=len(self.pairs),
                                       epilogues=self.epilogues)
                source = "fixed"
            else:
                exclude = frozenset(self._quarantine.get(sig, ()))
                plan = self.select(dec, exclude=exclude)
                source = "cost_model"
                if self.probe_every and self.misses % self.probe_every == 0:
                    probed = self._probe_pin(dec)
                    # the probe frontier doesn't know the quarantine; keep
                    # the cost-model fallback if it re-pinned a struck kernel
                    if not (self._plan_kernels(probed) & exclude):
                        plan = probed
                        source = "probe"
            if self.tele.audit.enabled:
                # every committed plan leaves a receipt: per-(layer, tier)
                # kernel choices with the modeled seconds selection compared
                modeled = sel_mod.plan_modeled_costs(
                    dec, plan.layers, self.pairs, self.dtype, hw=self.hw,
                    epilogues=self.epilogues)
                self.tele.audit.plan(
                    sig=sig, layers=plan.layers,
                    tiers=[s.name for s in dec.subgraphs],
                    modeled_s=modeled, source=source,
                    bell_slack=(self._bell_slack if self.adapt_budget_k
                                else None))
            self._store(sig, plan, self._anchor(dec))
            return plan, False

    def probe_margin(self) -> float | None:
        """The cost model's observed relative-error band, from this cache's
        own probe measurements: the median |measured - modeled| / modeled
        over recent probes (None until enough evidence).  Two candidates
        whose modeled costs differ by less than this are indistinguishable
        to the model — the probe widens to let the wall clock decide."""
        with self._lock:
            if len(self._probe_errs) < 4:
                return None
            rel = [abs(meas - mod) / max(mod, 1e-12)
                   for mod, meas in self._probe_errs[-64:]]
        return float(np.clip(np.median(rel), 0.05, 1.0))

    def _probe_pin(self, dec: Decomposed) -> KernelPlan:
        """Feedback probing through the cache (ROADMAP probe-on-Nth-miss):
        wall-clock-time the cost model's cheapest candidates per
        (layer, subgraph) and pin the measured winner — closing the loop
        the way full-batch warmup does, amortized over every future hit on
        this signature.  The frontier is top-2 until the cache has probe
        evidence, then widens (up to ``probe_k_max``) to every candidate
        inside the model's own error band (:meth:`probe_margin`), with
        ``probe_budget_s`` capping one miss's probe wall time.  With an
        ``edge_budget`` the timing runs on the budget-padded payload twin
        (the shapes the step executes — a real-nnz COO would underprice
        its padded runtime cost), placed on the cache's device; the
        cost-model ranking still reads the real stats."""
        self.probes += 1
        time_dec = (fix_shapes(dec, self.edge_budget)
                    if self.edge_budget else dec).to(self.device)
        timings = {} if self.tele.audit.enabled else None
        with self.tele.tracer.span("probe", cat="cache"):
            layers = sel_mod.probe_topk(dec, self.pairs, self.dtype,
                                        hw=self.hw,
                                        iters=self.probe_iters,
                                        time_dec=time_dec,
                                        epilogues=self.epilogues,
                                        k_max=self.probe_k_max,
                                        margin=self.probe_margin(),
                                        time_budget_s=self.probe_budget_s,
                                        errs=self._probe_errs,
                                        timings=timings)
        for (tier, kernel, fin, fout), (mod, meas) in sorted(
                (timings or {}).items()):
            self.tele.audit.probe(tier=tier, kernel=kernel, modeled_s=mod,
                                  measured_s=meas, in_dim=fin or None,
                                  agg_dim=fout)
        return KernelPlan.make(dec, layers, epilogues=self.epilogues)

    @property
    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.near_hits + self.misses
            out = dict(hits=self.hits, near_hits=self.near_hits,
                       misses=self.misses, entries=len(self._entries),
                       evictions=self.evictions, probes=self.probes,
                       quarantined=self.quarantined,
                       hit_rate=(self.hits + self.near_hits) / max(total, 1))
            if self.adapt_budget_k:
                spill = sum(a[0] for a in self._spill_by_sig.values())
                stored = sum(a[1] for a in self._spill_by_sig.values())
                out.update(bell_slack=self._bell_slack,
                           slack_changes=self.slack_changes,
                           spill_nnz=spill,
                           spill_frac=spill / max(spill + stored, 1))
            if self._probe_errs:
                out["probe_margin"] = self.probe_margin()
            return out
