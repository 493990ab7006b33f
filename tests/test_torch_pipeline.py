"""The port's asynchronous mini-batch pipeline (train/pipeline.py) on the
CPU, torch and numpy only: the BatchPipeline's unit behaviour (index-order
delivery, the ordered resolve stage, failures, shutdown, backpressure
counters, the starvation warning), the async batch stream against the
sequential one, and ``train_minibatch(prefetch_depth > 0)`` against the
synchronous loop bit for bit.  Parity with the reference is in
tests/test_torch_jax_parity.py.  Every wait is bounded: ``get`` takes a
timeout and every test ends with no ``pipeline-*`` thread alive."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from repro_torch.core import gnn as TGNN
from repro_torch.core import selector as sel_mod
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.graphs import graph as TG
from repro_torch.sampling import ClusterSampler, NeighborSampler, PlanCache
from repro_torch.train import gnn_steps
from repro_torch.train.pipeline import BatchPipeline, PipelineError

WAIT_S = 30.0       # the longest any get() or join here may block


def small_graph(n=160, e=1400, nf=5, nc=3, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    key = src.astype(np.int64) * n + dst
    _, keep = np.unique(key, return_index=True)
    src, dst = src[keep], dst[keep]
    feats = rng.standard_normal((n, nf)).astype(np.float32)
    labels = rng.integers(0, nc, n).astype(np.int32)
    return TG.Graph(n, src, dst, feats, labels, nc)


def cfg_of(**kw):
    base = dict(model="gcn", n_layers=2, hidden=8, comm_size=8,
                sampler="cluster", clusters_per_batch=4, inter_buckets=2,
                reorder="bfs", selector="cost_model", seed=11)
    base.update(kw)
    return TGNN.GNNConfig(**base)


def pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("pipeline-")]


def assert_no_pipeline_threads():
    """No pipeline worker alive, waiting at most WAIT_S for stragglers."""
    deadline = time.monotonic() + WAIT_S
    for t in pipeline_threads():
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    assert not pipeline_threads()


def get_all(pipe, n):
    return [pipe.get(timeout=WAIT_S) for _ in range(n)]


# -- BatchPipeline unit behaviour --------------------------------------------

def test_items_delivered_in_index_order_despite_racing_workers():
    def work(idx, ticket):
        if idx % 2 == 0:
            time.sleep(0.01)
        return (idx, ticket * 10)

    counter = iter(range(100))
    with BatchPipeline(lambda: next(counter), work, n_items=12,
                       prefetch_depth=4, workers=4) as pipe:
        out = get_all(pipe, 12)
    assert out == [(i, i * 10) for i in range(12)]
    assert pipe.stats["delivered"] == 12
    assert_no_pipeline_threads()


@pytest.mark.parametrize("workers,switch_s", [(4, None), (16, 1e-6)],
                         ids=["racing", "stress"])
def test_resolve_stage_runs_in_index_order_and_finish_races(workers,
                                                            switch_s):
    """work_fn completes out of order, yet resolve_fn runs 0..n-1 strictly
    in order and every item is finished once.  The stress case runs more
    workers than cores with a shortened switch interval: a lost update of
    the turnstile would reorder or drop a resolve."""
    resolved, finished = [], []

    def work(idx, ticket):
        if idx % 2 == 0:
            time.sleep(0.002)
        return ticket

    def resolve(idx, item):
        resolved.append(idx)
        return item

    def finish(idx, item):
        finished.append(idx)
        return item * 10

    n = 12 if switch_s is None else 200
    old = sys.getswitchinterval()
    try:
        if switch_s is not None:
            sys.setswitchinterval(switch_s)
        counter = iter(range(10 * n))
        with BatchPipeline(lambda: next(counter), work, n_items=n,
                           prefetch_depth=workers, workers=workers,
                           warn_after=n + 1, resolve_fn=resolve,
                           finish_fn=finish) as pipe:
            out = get_all(pipe, n)
    finally:
        sys.setswitchinterval(old)
    assert out == [i * 10 for i in range(n)]
    assert resolved == list(range(n))
    assert sorted(finished) == list(range(n))
    assert_no_pipeline_threads()


def test_failed_item_vacates_its_resolve_turn():
    resolved = []

    def work(idx, ticket):
        if idx == 1:
            raise ValueError("boom at 1")
        return ticket

    counter = iter(range(100))
    pipe = BatchPipeline(lambda: next(counter), work, n_items=6,
                         prefetch_depth=3, workers=3,
                         resolve_fn=lambda i, x: resolved.append(i) or x)
    assert pipe.get(timeout=WAIT_S) == 0
    with pytest.raises(ValueError, match="boom at 1"):
        pipe.get(timeout=WAIT_S)
    assert 1 not in resolved
    assert_no_pipeline_threads()


def test_worker_exception_propagates_and_closes():
    def work(idx, ticket):
        if idx == 3:
            raise ValueError("boom at 3")
        return idx

    counter = iter(range(100))
    pipe = BatchPipeline(lambda: next(counter), work, n_items=10,
                         prefetch_depth=2, workers=2)
    assert get_all(pipe, 3) == [0, 1, 2]
    with pytest.raises(ValueError, match="boom at 3"):
        pipe.get(timeout=WAIT_S)
    assert_no_pipeline_threads()
    with pytest.raises(PipelineError):
        pipe.get(timeout=WAIT_S)


def test_draw_exception_propagates_at_its_index():
    calls = dict(n=0)

    def draw():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("bad draw")
        return calls["n"]

    pipe = BatchPipeline(draw, lambda i, t: t, n_items=6,
                         prefetch_depth=2, workers=2)
    assert pipe.get(timeout=WAIT_S) == 1
    with pytest.raises(RuntimeError, match="bad draw"):
        pipe.get(timeout=WAIT_S)
    assert_no_pipeline_threads()


def test_clean_shutdown_midstream_and_after_drain():
    counter = iter(range(1000))
    pipe = BatchPipeline(lambda: next(counter),
                         lambda i, t: time.sleep(0.002) or t, n_items=500,
                         prefetch_depth=4, workers=3)
    assert pipe.get(timeout=WAIT_S) == 0
    pipe.close()
    pipe.close()                       # idempotent
    assert_no_pipeline_threads()
    with pytest.raises(PipelineError):
        pipe.get(timeout=WAIT_S)

    counter = iter(range(100))
    with BatchPipeline(lambda: next(counter), lambda i, t: t,
                       n_items=5, prefetch_depth=2, workers=2) as pipe:
        assert get_all(pipe, 5) == [0, 1, 2, 3, 4]
        with pytest.raises(PipelineError, match="already delivered"):
            pipe.get(timeout=WAIT_S)
    assert_no_pipeline_threads()


def test_backpressure_counters_and_depth_bound():
    max_ahead = dict(v=0)
    delivered = dict(v=0)

    def work(idx, ticket):
        max_ahead["v"] = max(max_ahead["v"], idx - delivered["v"])
        return idx

    counter = iter(range(100))
    depth = 3
    with BatchPipeline(lambda: next(counter), work, n_items=20,
                       prefetch_depth=depth, workers=2) as pipe:
        for _ in range(20):
            time.sleep(0.005)
            pipe.get(timeout=WAIT_S)
            delivered["v"] += 1
    s = pipe.stats
    assert s["wait_full_s"] > 0.0
    assert max_ahead["v"] <= depth + 1     # depth permits + the consumer's
    assert s["ready_mean"] > 0.0
    # the counters are the registry's pipeline.* instruments
    snap = pipe.tele.metrics.snapshot()
    assert snap["pipeline.wait_full_s"] == s["wait_full_s"]
    assert snap["pipeline.ready_depth"]["count"] == 20

    counter = iter(range(100))
    with BatchPipeline(lambda: next(counter),
                       lambda i, t: time.sleep(0.005) or t, n_items=8,
                       prefetch_depth=4, workers=1) as pipe:
        get_all(pipe, 8)
    assert pipe.stats["wait_empty_s"] > 0.0
    assert_no_pipeline_threads()


def test_starvation_warns_once():
    counter = iter(range(1000))
    with BatchPipeline(lambda: next(counter),
                       lambda i, t: time.sleep(0.003) or t, n_items=40,
                       prefetch_depth=4, workers=1, warn_after=8) as pipe:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            get_all(pipe, 40)
    starve = [w for w in rec if "prefetch queue averaged" in str(w.message)]
    assert len(starve) == 1
    assert pipe.stats["starved"] is True
    assert_no_pipeline_threads()


def test_retry_policy_raises_naming_the_roadmap():
    """``retry=`` runs now: the racing stages (work, finish) retry and
    count their retries, the ordered resolve never does.  Injected kernel
    faults (kernel quarantine, not ported) still raise naming ROADMAP
    section 1 item 7."""
    failed = set()

    def flaky_once(stage):
        def fn(i, t):
            if i % 3 == 1 and (stage, i) not in failed:
                failed.add((stage, i))
                raise ft.TransientError(f"{stage} {i}")
            return t
        return fn

    def resolve(i, t):
        if i == 5:
            raise ft.TransientError("resolve is never retried")
        return t * 10

    counter = iter(range(100))
    with BatchPipeline(lambda: next(counter), flaky_once("work"), n_items=6,
                       prefetch_depth=3, workers=2, resolve_fn=resolve,
                       finish_fn=flaky_once("finish"),
                       retry=ft.RetryPolicy(max_retries=2, base_delay_s=0.0),
                       retryable=ft.default_transient) as pipe:
        assert get_all(pipe, 5) == [i * 10 for i in range(5)]
        with pytest.raises(ft.TransientError, match="never retried"):
            pipe.get(timeout=WAIT_S)
    assert pipe.stats["retries"] == 4      # items 1 and 4, work and finish
    assert failed == {(s, i) for s in ("work", "finish") for i in (1, 4)}
    with pytest.raises(NotImplementedError, match="ROADMAP section 1 item 7"):
        gnn_steps.train_minibatch(
            small_graph(), cfg_of(prefetch_depth=2, retry_max=1), steps=1,
            device="cpu", fault_plan=ft.FaultPlan(
                kernel_faults={"bell": "compile"}))
    assert_no_pipeline_threads()


def test_get_times_out_on_a_stuck_item():
    release = threading.Event()
    pipe = BatchPipeline(lambda: 0,
                         lambda i, t: release.wait(WAIT_S) and t,
                         n_items=1, prefetch_depth=1, workers=1)
    with pytest.raises(PipelineError, match="not ready within"):
        pipe.get(timeout=0.05)
    release.set()
    pipe.close()
    assert_no_pipeline_threads()


# -- async batch stream == sequential batch stream ---------------------------

@pytest.mark.parametrize("make", [
    lambda g, s: ClusterSampler(g, block=8, clusters_per_batch=4,
                                method="bfs", seed=s),
    lambda g, s: NeighborSampler(g, batch_nodes=16, fanouts=(4, 2),
                                 method="bfs", block=8, seed=s),
], ids=["cluster", "neighbor"])
def test_async_batch_stream_matches_sequential(make):
    g = small_graph(n=96, e=700)
    ref_sampler = make(g, 7)
    n = 14                                         # crosses an epoch refill
    ref = [ref_sampler.sample() for _ in range(n)]
    pipe_sampler = make(g, 7)

    def work(idx, ticket):
        if idx % 3 == 0:
            time.sleep(0.004)
        return pipe_sampler.build(ticket)

    with BatchPipeline(pipe_sampler.draw, work, n_items=n,
                       prefetch_depth=4, workers=3) as pipe:
        got = get_all(pipe, n)
    for a, b in zip(ref, got):
        for f in ("nodes", "node_mask", "senders", "receivers",
                  "edge_mask", "features", "labels", "target_mask"):
            tp.assert_bytes_equal(getattr(a, f), getattr(b, f))
    # the sampler goes on as the sequential one after the pipeline closes
    tp.assert_bytes_equal(ref_sampler.sample().nodes,
                          pipe_sampler.sample().nodes)
    assert_no_pipeline_threads()


# -- async training == sync training -----------------------------------------

def run_pair(cfg, steps, **kw):
    g = small_graph()
    sync = gnn_steps.train_minibatch(g, cfg, steps=steps, device="cpu",
                                     **kw)
    asyn = gnn_steps.train_minibatch(
        g, dataclasses.replace(cfg, prefetch_depth=3, pipeline_workers=2),
        steps=steps, device="cpu", **kw)
    return sync, asyn


def assert_runs_identical(asyn, sync):
    assert asyn.losses == sync.losses             # bit for bit
    assert asyn.plans == sync.plans
    assert asyn.plan_history == sync.plan_history
    assert asyn.eval_plans == sync.eval_plans
    assert asyn.hit_history == sync.hit_history
    assert asyn.cache == sync.cache               # every counter
    assert asyn.n_traces == sync.n_traces == len(sync.plans)
    assert asyn.spill == sync.spill
    assert asyn.accuracy == sync.accuracy


@pytest.mark.parametrize("changes", [
    dict(),
    dict(model="sage", selector="fixed",
         fixed_kernels=("block_diag", "bell")),
    dict(sampler="neighbor", batch_nodes=16, fanouts=(4, 2)),
    dict(adapt_budget_k=True, max_ladder_recompiles=2),
    dict(model="gin", adapt_budget_k=True, selector="fixed",
         fixed_kernels=("block_diag", "bell")),
], ids=["cluster", "sage_fixed", "neighbor", "adapt_budget_k",
        "gin_fixed_adapt_budget_k"])
def test_async_training_matches_sync_bit_for_bit(changes):
    sync, asyn = run_pair(cfg_of(**changes), steps=12, eval_batches=2)
    assert_runs_identical(asyn, sync)
    assert sync.pipeline is None
    p = asyn.pipeline
    assert p["delivered"] == 12 and p["depth"] == 3 and p["workers"] == 2
    assert p["efficiency_pct"] > 0.0 and p["loop_seconds"] > 0.0
    assert (p["retries"], p["quarantined"], p["nonfinite_skips"]) == (0, 0, 0)
    assert set(asyn.stage_seconds) == set(sync.stage_seconds)
    assert asyn.telemetry["metrics"]["pipeline.ready_depth"]["count"] == 12
    assert_no_pipeline_threads()


def test_async_training_worker_failure_shuts_down_cleanly(monkeypatch):
    cfg = cfg_of(model="gin", selector="fixed",
                 fixed_kernels=("block_diag", "bell"), prefetch_depth=2,
                 pipeline_workers=2, seed=5)
    calls = dict(n=0)
    real = gnn_steps.prepare_skeleton

    def flaky(batch, cfg_, bell_slack=None):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("prepare blew up")
        return real(batch, cfg_, bell_slack=bell_slack)

    monkeypatch.setattr(gnn_steps, "prepare_skeleton", flaky)
    with pytest.raises(RuntimeError, match="prepare blew up"):
        gnn_steps.train_minibatch(small_graph(), cfg, steps=12,
                                  eval_batches=0, device="cpu")
    assert_no_pipeline_threads()


def test_plan_cache_concurrent_resolution_single_miss_per_signature():
    """Threads (more than this machine's cores, switching every
    microsecond) resolve six batches' signatures at random: each fresh
    signature pays one miss, and no resolution is lost."""
    g = small_graph()
    cfg = cfg_of(seed=2)
    sampler = gnn_steps.make_sampler(g, cfg)
    pad = sampler.edge_budget + sampler.node_budget
    pairs = TGNN.agg_width_pairs(cfg, g.features.shape[-1], g.n_classes)
    cache = PlanCache(pairs, hw=sel_mod.CPU_HW, edge_budget=pad,
                      device=tp.CPU)
    decs = []
    for _ in range(6):
        skel, _ = gnn_steps.prepare_skeleton(sampler.sample(), cfg)
        decs.append(skel.materialize(("block_diag", "bell", "csr"),
                                     device=None))
    n_threads, per_thread = 12, 12
    errs = []

    def hammer(t):
        rng = np.random.default_rng(t)
        try:
            for _ in range(per_thread):
                dec = decs[rng.integers(len(decs))]
                plan = cache.lookup(dec)
                if plan is None:
                    plan, _ = cache.plan_for(dec)
                assert plan is not None
        except BaseException as e:      # noqa: BLE001 — surfaced below
            errs.append(e)

    old = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    s = cache.stats
    assert s["hits"] + s["near_hits"] + s["misses"] == n_threads * per_thread
    assert s["misses"] == s["entries"] + s["evictions"]
    assert s["misses"] <= len({cache.signature(d) for d in decs})
