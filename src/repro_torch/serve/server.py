"""Resilient in-process GNN inference server (the AdaptGear read path).

Counterpart of ``repro/serve/server.py`` on ``device`` (the card unless
the caller asks for the CPU).  Dataflow per micro-batch:

    submit() -> AdmissionController (bounded queue, predictive shed)
            -> collect()            (micro-batch: flush on size | deadline)
            -> EgoNetSampler.build  (fixed-budget padded SampledBatch,
                                     ft.RetryPolicy w/ decorrelated jitter,
                                     FaultPlan injection point)
            -> prepare_skeleton -> PlanCache lookup/plan_for -> fix_shapes
            -> payloads, features and inverse degrees on the device
            -> infer step           (one shape record per (plan, shapes),
                                     made at warmup: none in steady state)
            -> logits (one copy to the host) -> per-request futures

Robustness properties:

* **bounded everything** — the queue sheds at capacity and predictively
  (admission.py); an admitted request is never dropped afterwards: it
  finishes ``ok``, or ``error`` with the exception when its batch fails.
* **graceful degradation** — sustained overload steps the fanout ladder
  down to a cheaper pre-recorded shape (degrade.py) instead of queuing;
  calm steps back up, with hysteresis so the rung never flaps.
* **cold-start robustness** — :meth:`InferenceServer.warmup` preloads a
  :meth:`PlanCache.load` snapshot (plans bit-identical to the run that
  saved them) and runs every (rung, plan) pair once up front, so a
  warm-started server makes no new shape record in steady state
  (``n_traces`` is the observable, as the reference counts its traces).
* **observability** — per-request latency histograms (p50/p99), queue
  wait, shed/timeout/degrade counters, and spans over every stage ride
  the run's ``repro_torch.obs`` Telemetry.

What differs from the reference:

* Shape records.  The reference compiles one executable per (plan, leaf
  shapes).  The port's infer step (``gnn_steps.make_infer_step``) keeps
  one shape record and raises on a batch of other shapes, and two rungs
  that share a plan differ in node and edge budget; so the server keeps
  one infer step per (plan layers, tensor shapes), each counted once in
  ``counters["traces"]`` when it records its shapes.
* No kernel quarantine (ROADMAP section 1 item 7).  A kernel that fails
  to build or launch on the request path fails its batch: the batch's
  requests finish ``error`` with the exception and ``serve.errors``
  counts them; the batch is never re-run on another plan, on the plain
  versions or on the CPU.  :meth:`warmup` raises on such a kernel
  instead of skipping it, so a broken kernel cannot hide until the first
  request.  A ``FaultPlan`` with ``kernel_faults`` raises
  ``NotImplementedError``.  ``stats()`` keeps the reference's keys;
  ``quarantined`` and ``recoveries`` stay 0.
* :func:`plan_cache_for` builds the PlanCache a server makes when given
  none; with ``fixed_kernels`` that cache commits one plan on every miss
  instead of selecting (``PlanCache(fixed_kernels=)``, port only), which
  serves a fixed-selector model on the plan it trained on.  The server
  itself resolves every batch through its PlanCache, as the reference's.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core import gnn, selector as sel_mod
from repro_torch.core.plan import KernelPlan
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.graphs import graph as graph_mod
from repro_torch.kernels import _build
from repro_torch.obs import Telemetry, get_logger
from repro_torch.sampling.plan_cache import (MB_KERNELS, PlanCache,
                                             fix_shapes, plan_payload_keys)
from repro_torch.serve.admission import (ERROR, OK, SHED, AdmissionController,
                                         Request)
from repro_torch.serve.degrade import DegradationLadder
from repro_torch.serve.ego import EgoNetSampler, default_rungs
from repro_torch.train.gnn_steps import (make_infer_step, prepare_skeleton,
                                         refuse_unported, tensor_shapes)

__all__ = ["ServeConfig", "InferenceServer", "plan_cache_for"]

_log = get_logger("repro_torch.serve")


@dataclass
class ServeConfig:
    """Serving knobs (the model/sampling knobs stay on GNNConfig)."""
    deadline_s: float = 0.25      # default per-request deadline
    queue_limit: int = 64         # admission bound (requests)
    max_batch: int = 16           # micro-batch size flush target (seeds)
    max_wait_s: float = 0.01      # coalescing cap: a partial batch never
    #                               waits longer than this for company
    rungs: tuple = ()             # fanout ladder; () = derived from
    #                               cfg.fanouts by repeated halving
    down_after: int = 2           # ladder hysteresis (degrade.py)
    up_after: int = 6
    cooldown: int = 3
    ewma_alpha: float = 0.3       # service-time estimate smoothing
    est_service_s: float = 0.02   # pre-warmup service estimate
    retry_max: int = 2            # transient build retries (0 = off)
    retry_base_delay_s: float = 0.002
    plan_cache_path: str = ""     # PlanCache.save/load snapshot for warmup
    seed: int = 0                 # retry-jitter determinism


def plan_cache_for(graph: graph_mod.Graph, cfg: gnn.GNNConfig,
                   edge_budget: int, *, hw: sel_mod.HwModel | None = None,
                   fixed_kernels: tuple | None = None,
                   telemetry: Telemetry | None = None,
                   device: str | torch.device = DEFAULT_DEVICE) -> PlanCache:
    """The PlanCache an :class:`InferenceServer` over ``(graph, cfg)``
    builds when given none: priced by ``hw`` (the cost model of
    ``device`` by default), padded to ``edge_budget`` (the server's
    ``ego.pad_budget(0)``), never probing.  With ``fixed_kernels`` (one
    kernel per tier) it commits that plan on every miss instead."""
    device = resolve_device(device)
    in_dim = graph.features.shape[-1]
    return PlanCache(
        gnn.agg_width_pairs(cfg, in_dim, graph.n_classes), dtype=np.float32,
        hw=hw or sel_mod.default_hw(device), max_entries=cfg.cache_entries,
        probe_every=0, edge_budget=edge_budget,
        epilogues=gnn.layer_epilogues(cfg, in_dim, graph.n_classes),
        telemetry=telemetry, device=device, fixed_kernels=fixed_kernels)


class InferenceServer:
    """In-process ego-net inference over a trained model on ``device``.

    ``plan_cache`` may be the training run's cache (its committed plans
    carry over); otherwise a fresh one, priced by the cost model of
    ``device``, is built and optionally preloaded from
    ``serve_cfg.plan_cache_path`` at :meth:`warmup`.  ``params`` are
    copied to ``device`` (never written into).  ``fault_plan`` injects
    deterministic build faults on the request path (``on_built``, keyed
    by the ego stream index, retried by the jittered policy); one with
    ``kernel_faults`` raises ``NotImplementedError`` (no quarantine)."""

    def __init__(self, graph: graph_mod.Graph, cfg: gnn.GNNConfig, params,
                 serve_cfg: ServeConfig | None = None,
                 plan_cache: PlanCache | None = None,
                 fault_plan: "ft.FaultPlan | None" = None,
                 telemetry: Telemetry | None = None,
                 clock=time.monotonic, *,
                 device: str | torch.device = DEFAULT_DEVICE):
        if cfg.model not in ("gcn", "gin", "sage"):
            raise ValueError(f"serving supports gcn/gin/sage, "
                             f"not {cfg.model!r}")
        refuse_unported(fault_plan)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = serve_cfg or ServeConfig()
        self.params = [{k: v.detach().to(self.device, torch.float32)
                        for k, v in layer.items()} for layer in params]
        self.fault_plan = fault_plan
        self.clock = clock
        self.tele = telemetry if telemetry is not None else Telemetry()
        m = self.tele.metrics
        rungs = self.scfg.rungs or default_rungs(cfg.fanouts)
        self.ego = EgoNetSampler(graph, cfg, rungs)

        if plan_cache is not None:
            plan_cache.attach_telemetry(self.tele)
        self.cache = plan_cache or plan_cache_for(
            graph, cfg, self.ego.pad_budget(0), telemetry=self.tele,
            device=self.device)

        self.ladder = DegradationLadder(
            len(self.ego), down_after=self.scfg.down_after,
            up_after=self.scfg.up_after, cooldown=self.scfg.cooldown,
            metrics=m)
        self._est_service = float(self.scfg.est_service_s)
        self.admission = AdmissionController(
            self.scfg.queue_limit, self._estimate_wait, clock=clock,
            metrics=m)
        self.retry = (ft.RetryPolicy(
            max_retries=self.scfg.retry_max,
            base_delay_s=self.scfg.retry_base_delay_s,
            jitter=True, seed=self.scfg.seed,
            tracer=self.tele.tracer if self.tele.enabled else None)
            if self.scfg.retry_max > 0 else None)

        # (plan.layers, tensor shapes) -> infer step with that one shape
        # record; plan.layers -> its canonical signature
        self._counters = dict(traces=0)
        self._infer_fns: dict[tuple, object] = {}
        self._sig_of_layers: dict[tuple, tuple] = {}
        self._record_lock = threading.Lock()
        # port only: batches served per plan (plan.layers -> count), what
        # the launches of the request path follow from
        self.plan_batches: dict[tuple, int] = {}

        self._c_batches = m.counter("serve.batches")
        self._c_errors = m.counter("serve.errors")
        self._c_retries = m.counter("serve.retries")
        # the reference's quarantine counters: 0 here (no quarantine)
        self._c_quar = m.counter("serve.quarantined")
        self._c_recov = m.counter("serve.recoveries")
        self._c_shed = m.counter("serve.shed")        # shared w/ admission
        self._c_timeouts = m.counter("serve.timeouts")
        self._h_latency = m.histogram("serve.latency_s", window=4096)
        self._h_service = m.histogram("serve.service_s")
        self._h_bsize = m.histogram("serve.batch_size")
        self._g_qlen = m.gauge("serve.queue_len")
        self._last_pain = 0

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- load estimation ----------------------------------------------------

    def _estimate_wait(self, queue_len: int) -> float:
        """Expected seconds until a request arriving behind ``queue_len``
        others is served: whole micro-batches ahead of it, each one EWMA
        service time (admission's predictive-shed input)."""
        batches_ahead = queue_len // max(self.scfg.max_batch, 1) + 1
        return batches_ahead * self._est_service

    @property
    def n_traces(self) -> int:
        return self._counters["traces"]

    # -- plan resolution and shape records ----------------------------------

    def _infer_fn(self, plan: KernelPlan, args: tuple):
        """The infer step of (plan, the shapes of ``args``), made and its
        shape record counted on first use.  On the card the GNN kernel
        libraries are loaded first, so the record's first call never
        waits on nvcc (and a build failure fails here)."""
        key = (plan.layers, tensor_shapes(args))
        fn = self._infer_fns.get(key)
        if fn is None:
            with self._record_lock:
                fn = self._infer_fns.get(key)
                if fn is None:
                    if self.device.type == "cuda":
                        _build.build_all(_build.GNN_SOURCES)
                    fn = make_infer_step(self.cfg, plan, self._counters)
                    fn.record.check(args)
                    self._infer_fns[key] = fn
        return fn

    def _plan_of(self, skel):
        """(plan, host payloads) for one batch's skeleton: the PlanCache's
        plan (selection on a miss)."""
        plan = self.cache.lookup(skel)
        if plan is None:
            plan, _ = self.cache.plan_for(
                skel.materialize(MB_KERNELS, device=None))
        return plan, skel.materialize(plan_payload_keys(plan), device=None)

    def _stage(self, rung: int, batch, skel, inv_deg, plan, dec) -> tuple:
        """The infer tail ``(fixed_dec, x, inv_deg)`` on the device: the
        plan's payloads padded to the rung's budget and stamped with the
        plan's canonical signature (the first one seen for its layers, as
        in training)."""
        csig = self._sig_of_layers.setdefault(plan.layers,
                                              self.cache.signature(skel))
        fixed = fix_shapes(dec, self.ego.pad_budget(rung),
                           keep=plan_payload_keys(plan), stats=csig)
        return (fixed.to(self.device),
                torch.as_tensor(batch.features).to(self.device),
                torch.as_tensor(inv_deg).to(self.device))

    def _resolve(self, rung: int, batch) -> tuple:
        """PlanCache resolution + fixed-shape padding for one batch:
        returns (plan, args) with args the infer tail on the device."""
        skel, inv_deg = prepare_skeleton(batch, self.cfg)
        plan, dec = self._plan_of(skel)
        return plan, self._stage(rung, batch, skel, inv_deg, plan, dec)

    def _infer(self, plan: KernelPlan, args: tuple) -> np.ndarray:
        """Logits on the host: one copy, which is also the sync that
        surfaces an asynchronous launch error here."""
        return self._infer_fn(plan, args)(self.params, *args).cpu().numpy()

    def infer_step(self, rung: int, batch):
        """(plan, run) for one built batch: ``run()`` launches the batch's
        infer step on the device and returns its logits there (no host
        copy), for timing and profiling one batch's inference."""
        plan, args = self._resolve(rung, batch)
        fn = self._infer_fn(plan, args)
        return plan, lambda: fn(self.params, *args)

    # -- the serving path ---------------------------------------------------

    def _build(self, rung: int, seeds, index: int):
        """Sampler build + fault injection, the unit the jittered retry
        policy re-runs on a transient failure (injection precedes the
        skeleton, so a retried batch never double-counts the cache)."""
        def once():
            batch = self.ego.build(rung, seeds, index)
            if self.fault_plan is not None:
                batch = self.fault_plan.on_built(index, batch)
            return batch

        if self.retry is None:
            return once()
        return self.retry.run(once, on_retry=lambda a: self._c_retries.inc(),
                              retryable=ft.default_transient)

    def _serve_batch(self, rung: int, reqs: list[Request]) -> None:
        tracer = self.tele.tracer
        t0 = self.clock()
        seeds = sorted({r.node for r in reqs})
        index = self.ego.next_index()
        try:
            with tracer.span("serve.batch", cat="serve", index=index,
                             rung=rung, n=len(reqs)):
                with tracer.span("serve.build", cat="host"):
                    batch = self._build(rung, seeds, index)
                with tracer.span("serve.resolve", cat="host"):
                    plan, args = self._resolve(rung, batch)
                with tracer.span("serve.infer", cat="device",
                                 plan=str(plan.layers[0])):
                    logits = self._infer(plan, args)
        except Exception as exc:
            # permanent failure (a non-transient build, a kernel that
            # fails to build or launch): the admitted requests get an
            # explicit error, never silence and never another plan
            self._c_errors.inc(len(reqs))
            for r in reqs:
                r.future.finish(ERROR, exc)
            return
        self.plan_batches[plan.layers] = (
            self.plan_batches.get(plan.layers, 0) + 1)
        row_of = {int(n): i for i, n in enumerate(batch.nodes) if n >= 0}
        now = self.clock()
        for r in reqs:
            row = logits[row_of[r.node]]
            r.future.finish(OK, dict(node=r.node, rung=rung,
                                     pred=int(np.argmax(row)),
                                     logits=row.copy(),
                                     latency_s=now - r.t_submit))
            self._h_latency.observe(now - r.t_submit)
            if self.tele.enabled:
                with tracer.span("serve.request", cat="serve", node=r.node,
                                 latency_s=now - r.t_submit):
                    pass
        service = now - t0
        self._h_service.observe(service)
        self._h_bsize.observe(len(reqs))
        self._c_batches.inc()
        a = self.scfg.ewma_alpha
        self._est_service = (1 - a) * self._est_service + a * service
        qlen = len(self.admission)
        self._g_qlen.set(qlen)
        # ladder signal: shedding/expiry since the last batch, or a queue
        # holding more than one flush's worth of backlog
        pain = self._c_shed.value + self._c_timeouts.value
        overloaded = (pain > self._last_pain
                      or qlen >= max(self.scfg.queue_limit // 2, 1))
        self._last_pain = pain
        self.ladder.observe(overloaded)

    # -- public API ---------------------------------------------------------

    def submit(self, node: int, deadline_s: float | None = None):
        """Enqueue one ego-net query; returns its :class:`ServeFuture`
        (already finished with status ``shed`` if admission rejected)."""
        return self.admission.submit(
            int(node),
            self.scfg.deadline_s if deadline_s is None else deadline_s)

    def step(self) -> int:
        """Serve one micro-batch inline (deterministic single-threaded
        mode for tests/benchmarks — no background thread).  Returns the
        number of requests terminated (served or expired)."""
        rung = self.ladder.rung
        before = self._c_timeouts.value
        reqs = self.admission.collect(
            min(self.scfg.max_batch, self.ego.max_seeds(rung)),
            self._est_service, stop=self._stop,
            max_wait_s=self.scfg.max_wait_s)
        expired = self._c_timeouts.value - before
        if reqs:
            self._serve_batch(rung, reqs)
        return len(reqs) + int(expired)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                _log.exception("serving loop error")

    def start(self) -> "InferenceServer":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="serve-loop", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        for r in self.admission.drain():    # unserved stragglers: shed,
            if r.future.finish(SHED):       # never silently dropped
                self._c_shed.inc()

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- warm start ---------------------------------------------------------

    def warmup(self, path: str | None = None, save: bool = False,
               probe_seeds=None) -> dict:
        """Cold-start mitigation: optionally preload a persisted PlanCache
        snapshot (plans bit-identical to the saving run; a corrupt file
        falls back to cold start), then run one probe batch per rung under
        every plan, so every steady-state (plan, shapes) pair has its
        shape record before the first request arrives.  A kernel that
        fails to build or launch raises here.  With ``save=True`` the
        (possibly newly selected) plans are persisted back for the next
        cold start.

        Returns ``dict(loaded, new_traces, rungs)`` — a warm-started
        server re-warmed from its own snapshot serves steady-state
        batches with ``n_traces`` unchanged (the acceptance observable)."""
        path = self.scfg.plan_cache_path if path is None else path
        loaded = bool(path) and self.cache.load(path)
        t0 = self.n_traces
        n = self.ego.graph.n
        if probe_seeds is None:
            k = min(self.scfg.max_batch, self.ego.max_seeds(0), n)
            probe_seeds = np.unique(np.linspace(0, n - 1, k).astype(int))
        # pass 1 — one probe per rung: commits a plan for each rung's
        # density signature (selection happens now, not on a request)
        probes, plans = [], {}
        for rung in range(len(self.ego)):
            batch = self.ego.build(rung, probe_seeds, self.ego.next_index())
            skel, inv_deg = prepare_skeleton(batch, self.cfg)
            plan, _ = self._plan_of(skel)
            self._sig_of_layers.setdefault(plan.layers,
                                           self.cache.signature(skel))
            probes.append((rung, batch, skel, inv_deg))
        # pass 2 — the (plan x rung) cross product: a plan committed for
        # one rung's signature can be served at any rung (loaded snapshot
        # entries, plan drift between batches), and the shape records are
        # keyed by (plan, shapes), so every pair needs its record up front
        # for steady state to make none
        for _, p, _ in self.cache.state_dict()["entries"]:
            plans.setdefault(p.layers, p)
        for rung, batch, skel, inv_deg in probes:
            for p in plans.values():
                dec = skel.materialize(plan_payload_keys(p), device=None)
                self._infer(p, self._stage(rung, batch, skel, inv_deg, p,
                                           dec))

        if save and path:
            self.cache.save(path)
        return dict(loaded=loaded, new_traces=self.n_traces - t0,
                    rungs=len(self.ego))

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        m = self.tele.metrics
        admitted = m.counter("serve.admitted").value
        shed = self._c_shed.value
        return dict(
            admitted=admitted, shed=shed,
            timeouts=self._c_timeouts.value,
            errors=self._c_errors.value,
            batches=self._c_batches.value,
            retries=self._c_retries.value,
            quarantined=self._c_quar.value,
            recoveries=self._c_recov.value,
            degrades=m.counter("serve.degrades").value,
            restores=m.counter("serve.restores").value,
            rung=self.ladder.rung,
            n_traces=self.n_traces,
            est_service_s=self._est_service,
            shed_pct=100.0 * shed / max(admitted + shed, 1),
            latency=self._h_latency.snapshot(),
            service=self._h_service.snapshot(),
            batch_size=self._h_bsize.snapshot(),
            queue_wait=m.histogram("serve.queue_wait_s").snapshot())
