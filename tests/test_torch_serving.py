"""The port's GNN inference server (repro_torch.serve, launch/serve.py) on
the CPU, torch and numpy only: the reference's tests/test_serving.py
(ego tickets, PlanCache persistence, retry jitter, admission control and
micro-batching, the degradation ladder, the server end to end, warm
starts and transient build faults retried on the request path), case for
case, with ``device="cpu"``; then the port's own: injected kernel faults
(kernel quarantine) raise naming the ROADMAP item, a kernel that fails on
the request path fails its batch's requests and is never replaced, and
warmup raises on it.  Parity with the reference's server is in
tests/test_torch_jax_parity.py.  Every wait is bounded and every test
ends with no ``serve-loop`` thread alive."""
import torch_parity as tp  # noqa: F401,I001  (first: pins torch to one thread)

import os
import threading
import time
import warnings

import numpy as np
import pytest

from repro_torch.core import gnn
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.graphs import graph as G
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.sampling.plan_cache import PlanCache
from repro_torch.serve import (ERROR, OK, SHED, TIMEOUT, AdmissionController,
                               DegradationLadder, EgoNetSampler,
                               InferenceServer, ServeConfig, default_rungs)
from repro_torch.serve.server import plan_cache_for
from repro_torch.train import gnn_steps


def serve_cfg(**kw):
    d = dict(deadline_s=5.0, queue_limit=16, max_batch=8, max_wait_s=0.002)
    d.update(kw)
    return ServeConfig(**d)


def gnn_cfg(**kw):
    d = dict(model="gcn", sampler="neighbor", batch_nodes=16,
             fanouts=(4, 2), hidden=8, n_layers=2, comm_size=16, seed=0)
    d.update(kw)
    return gnn.GNNConfig(**d)


def cora():
    return G.synth_dataset("cora", scale=0.1, seed=0)


def train(g, cfg, steps):
    return gnn_steps.train_minibatch(g, cfg, steps=steps, eval_batches=0,
                                     device="cpu")


def small_server(g=None, cfg=None, scfg=None, steps=4, **server_kw):
    g = g if g is not None else cora()
    cfg = cfg or gnn_cfg()
    res = train(g, cfg, steps)
    return InferenceServer(g, cfg, res.params, serve_cfg=scfg or serve_cfg(),
                           plan_cache=res.plan_cache, device="cpu",
                           **server_kw)


def drive(server, futs, max_steps=1000):
    """Single-threaded deterministic serving: step until every future
    lands (bounded)."""
    for _ in range(max_steps):
        if all(f.done() for f in futs):
            break
        server.step()
    return [f.result(0) for f in futs]


def assert_no_serve_threads():
    alive = [t.name for t in threading.enumerate()
             if t.name == "serve-loop"]
    assert not alive, alive


# -- ego tickets (sampling/sampler.py satellite) ------------------------------

def test_ego_ticket_dedupes_validates_and_reproduces():
    g = cora()
    cfg = gnn_cfg()
    s = gnn_steps.make_sampler(g, cfg)
    t = s.ego_ticket([5, 3, 5, 3, 9], index=7)
    assert t.index == 7
    assert t.chosen.tolist() == [3, 5, 9]          # deduped, sorted
    with pytest.raises(ValueError):
        s.ego_ticket([], index=0)
    with pytest.raises(ValueError):
        s.ego_ticket([g.n], index=0)
    with pytest.raises(ValueError):
        s.ego_ticket([-1], index=0)
    with pytest.raises(ValueError):
        s.ego_ticket(list(range(cfg.batch_nodes + 1)), index=0)
    # pure in (seed set, index): bit-identical rebuilds on any thread
    a = s.build(s.ego_ticket([3, 5, 9], 7))
    b = s.build(s.ego_ticket([9, 5, 3, 3], 7))
    np.testing.assert_array_equal(a.nodes, b.nodes)
    np.testing.assert_array_equal(a.senders, b.senders)
    np.testing.assert_array_equal(a.features, b.features)
    # the epoch stream is untouched by ego queries
    assert s._n_drawn == 0


# -- PlanCache disk persistence (satellite) -----------------------------------

def trained_cache():
    return train(cora(), gnn_cfg(), 5).plan_cache


def test_plan_cache_save_load_bit_identical(tmp_path):
    cache = trained_cache()
    path = str(tmp_path / "plans.bin")
    cache.save(path)
    fresh = PlanCache(cache.pairs, dtype=np.float32, device="cpu")
    assert fresh.load(path)
    a, b = cache.state_dict(), fresh.state_dict()
    assert a["entries"] == b["entries"]      # plans bit-identical
    assert a == b                            # counters/ladder/quarantine too


def test_plan_cache_load_missing_and_corrupt(tmp_path):
    cache = trained_cache()
    before = cache.state_dict()
    assert not cache.load(str(tmp_path / "nope.bin"))   # missing: quiet
    path = str(tmp_path / "plans.bin")
    cache.save(path)
    blob = open(path, "rb").read()
    for corrupt in [b"garbage", blob[:-4], blob[:11] + b"\xff" + blob[12:]]:
        with open(path, "wb") as f:
            f.write(corrupt)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert not cache.load(path)                 # corrupt: cold start
        assert any("starting cold" in str(x.message) for x in w)
        assert cache.state_dict() == before             # cache untouched
    assert not os.path.exists(path + ".tmp")            # atomic write


# -- decorrelated retry jitter (satellite) ------------------------------------

# the reference's two jitter tests are ported in test_torch_fault_tolerance.py
# (the RetryPolicy's own file); collected here too, case for case
from test_torch_fault_tolerance import (  # noqa: E402,F401,I001
    test_retry_jitter_deterministic_and_decorrelated,
    test_retry_without_jitter_unchanged)


# -- admission control + micro-batching ---------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_admission_sheds_on_full_queue_and_hopeless_deadline():
    clk = FakeClock()
    adm = AdmissionController(limit=2, estimate_wait=lambda q: 0.0,
                              clock=clk)
    f1, f2 = adm.submit(1, 1.0), adm.submit(2, 1.0)
    f3 = adm.submit(3, 1.0)                       # queue full
    assert f3.status == SHED and f3.done()
    assert f1.status == f2.status == "pending"
    slow = AdmissionController(limit=8, estimate_wait=lambda q: 0.5,
                               clock=clk)
    assert slow.submit(1, 0.1).status == SHED     # predicted wait > deadline
    assert slow.submit(2, 1.0).status == "pending"


def test_deadline_expired_requests_shed_not_served():
    clk = FakeClock()
    adm = AdmissionController(limit=8, estimate_wait=lambda q: 0.0,
                              clock=clk)
    futs = [adm.submit(i, 0.05) for i in range(3)]
    clk.t += 1.0                                   # deadlines long gone
    live = adm.submit(99, 5.0)
    got = adm.collect(max_n=1, service_s=0.01)     # size flush: no wall wait
    assert [r.node for r in got] == [99]           # expired never served
    for f in futs:
        assert f.status == TIMEOUT and f.done()
    assert live.status == "pending"


def test_microbatch_flush_on_size():
    clk = FakeClock()
    adm = AdmissionController(limit=32, estimate_wait=lambda q: 0.0,
                              clock=clk)
    futs = [adm.submit(i, 10.0) for i in range(8)]
    t0 = time.perf_counter()
    got = adm.collect(max_n=4, service_s=0.01)
    assert len(got) == 4                           # size flush, no waiting
    assert time.perf_counter() - t0 < 1.0
    assert len(adm) == 4
    assert all(f.status == "pending" for f in futs)


def test_microbatch_flush_on_deadline():
    adm = AdmissionController(limit=32, estimate_wait=lambda q: 0.0)
    adm.submit(1, 0.08)
    t0 = time.perf_counter()
    got = adm.collect(max_n=8, service_s=0.02)     # never fills: must flush
    dt = time.perf_counter() - t0                  # on deadline slack
    assert [r.node for r in got] == [1]
    assert dt < 0.08                               # before the deadline
    assert dt >= 0.02                              # after some coalescing


def test_microbatch_max_wait_caps_coalescing():
    adm = AdmissionController(limit=32, estimate_wait=lambda q: 0.0)
    adm.submit(1, 10.0)                            # generous deadline
    t0 = time.perf_counter()
    got = adm.collect(max_n=8, service_s=0.01, max_wait_s=0.02)
    assert len(got) == 1
    assert time.perf_counter() - t0 < 5.0          # not the whole deadline


# -- degradation ladder hysteresis --------------------------------------------

def test_ladder_steps_down_and_up_with_hysteresis():
    lad = DegradationLadder(3, down_after=2, up_after=4, cooldown=0)
    assert not lad.observe(True)
    assert lad.observe(True) and lad.rung == 1      # 2 consecutive hot
    for _ in range(3):
        assert not lad.observe(False)
    assert lad.observe(False) and lad.rung == 0     # 4 consecutive calm
    assert not lad.observe(False)                   # floor: no underflow


def test_ladder_never_flaps():
    lad = DegradationLadder(3, down_after=2, up_after=4, cooldown=2)
    for i in range(40):                             # alternating load:
        assert not lad.observe(i % 2 == 0)          # never a transition
    assert lad.rung == 0
    # a square wave of load: cooldown damps the transition rate — a
    # 2-rung ladder moves at most once per half-period
    lad2 = DegradationLadder(2, down_after=2, up_after=4, cooldown=2)
    changes = sum(lad2.observe(True) for _ in range(10))
    assert changes == 1 and lad2.rung == 1
    changes = sum(lad2.observe(False) for _ in range(10))
    assert changes == 1 and lad2.rung == 0


def test_ladder_rejects_degenerate_hysteresis():
    with pytest.raises(ValueError):
        DegradationLadder(3, down_after=4, up_after=4)
    with pytest.raises(ValueError):
        DegradationLadder(0)


def test_default_rungs_halve_to_floor():
    assert default_rungs((8, 4)) == ((8, 4), (4, 2), (2, 1))
    assert default_rungs((1, 1)) == ((1, 1),)


# -- the server end to end ----------------------------------------------------

def test_server_serves_admitted_requests():
    srv = small_server()
    srv.warmup()
    t0 = srv.n_traces
    futs = [srv.submit(i * 3 % srv.ego.graph.n) for i in range(12)]
    results = drive(srv, futs)
    assert {s for s, _ in results} == {OK}
    for (_, v), f in zip(results, futs):
        assert v["logits"].shape == (srv.ego.graph.n_classes,)
        assert v["pred"] == int(np.argmax(v["logits"]))
    assert srv.n_traces == t0                   # warm: zero new records
    st = srv.stats()
    assert st["admitted"] == 12 and st["errors"] == 0


def test_server_background_thread_and_stop_sheds_stragglers():
    srv = small_server(scfg=serve_cfg(est_service_s=0.001))
    srv.warmup()
    with srv:
        futs = [srv.submit(i % srv.ego.graph.n) for i in range(6)]
        assert all(f.result(timeout=30)[0] == OK for f in futs)
    assert_no_serve_threads()
    # post-stop: anything still queued is shed, never silently dropped
    late = srv.admission.submit(0, 5.0)
    srv.stop()
    assert late.status in (SHED, "pending") or late.done()


def test_server_sheds_under_synthetic_overload():
    # a giant service estimate makes every deep-queue arrival hopeless:
    # the controller must shed rather than queue unboundedly
    srv = small_server(scfg=serve_cfg(queue_limit=4, est_service_s=3.0,
                                      deadline_s=1.0))
    futs = [srv.submit(i % srv.ego.graph.n) for i in range(12)]
    assert sum(f.status == SHED for f in futs) == 12   # est_wait > deadline
    st = srv.stats()
    assert st["shed"] == 12 and st["shed_pct"] == 100.0


def test_warm_start_from_persisted_cache_bit_identical(tmp_path):
    path = str(tmp_path / "plans.bin")
    g = cora()
    cfg = gnn_cfg()
    res = train(g, cfg, 4)

    writer = InferenceServer(g, cfg, res.params, serve_cfg=serve_cfg(),
                             plan_cache=res.plan_cache, device="cpu")
    writer.warmup()
    futs = [writer.submit(i * 5 % g.n) for i in range(10)]
    ref = drive(writer, futs)
    writer.cache.save(path)
    saved = {sig: (plan, anchor)
             for sig, plan, anchor in writer.cache.state_dict()["entries"]}

    # cold process: fresh server + fresh cache, warm-started from disk
    reader = InferenceServer(g, cfg, res.params, serve_cfg=serve_cfg(),
                             device="cpu")
    warm = reader.warmup(path=path)
    assert warm["loaded"]
    # plans bit-identical to the writer's snapshot (warmup probes may
    # reorder the LRU, so compare as a mapping)
    got = {sig: (plan, anchor)
           for sig, plan, anchor in reader.cache.state_dict()["entries"]}
    assert got == saved
    t0 = reader.n_traces
    futs = [reader.submit(i * 5 % g.n) for i in range(10)]
    out = drive(reader, futs)
    assert reader.n_traces == t0            # steady state: zero records
    # identical params + identical plans -> identical predictions
    for (sa, va), (sb, vb) in zip(ref, out):
        assert sa == sb == OK and va["pred"] == vb["pred"]
        np.testing.assert_allclose(va["logits"], vb["logits"],
                                   rtol=1e-6, atol=1e-6)


def test_warmup_corrupt_cache_falls_back_cold(tmp_path):
    path = str(tmp_path / "plans.bin")
    with open(path, "wb") as f:
        f.write(b"not a plan cache")
    srv = small_server()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warm = srv.warmup(path=path)
    assert not warm["loaded"]               # cold start, not a crash
    futs = [srv.submit(0)]
    assert drive(srv, futs)[0][0] == OK


def test_transient_build_faults_retried_on_request_path():
    # injections are keyed by the ego stream index: warmup consumes one
    # probe per rung (fanouts (4, 2) halve into 3 rungs -> indices 0..2),
    # so the first query batches land on 3 and 4 — the jittered retry
    # policy must absorb their transient build faults without the client
    # ever noticing
    fp = ft.FaultPlan(worker_faults={3: 1, 4: 2})
    srv = small_server(scfg=serve_cfg(retry_max=3, retry_base_delay_s=0.001),
                       fault_plan=fp)
    assert len(srv.ego) == 3
    srv.warmup()
    futs = [srv.submit(i % srv.ego.graph.n) for i in range(4)]
    results = drive(srv, futs)
    assert {s for s, _ in results} == {OK}
    assert fp.injected_worker >= 1
    assert srv.stats()["retries"] >= 1 and srv.stats()["errors"] == 0


# -- the port's own: no kernel quarantine -------------------------------------

def test_kernel_faults_raise_naming_the_roadmap():
    fp = ft.FaultPlan(kernel_faults={"bell": "execute"})
    with pytest.raises(NotImplementedError, match="ROADMAP section 1 item 7"):
        small_server(fault_plan=fp)
    assert fp.injected_worker == 0


FIXED = ("block_diag", "bell")


def fixed_server(**server_kw):
    """A GCN trained 4 steps on the FIXED plan, served through a PlanCache
    that commits FIXED on every miss (``plan_cache_for(fixed_kernels=)``)."""
    g = cora()
    cfg = gnn_cfg(selector="fixed", fixed_kernels=FIXED)
    res = train(g, cfg, 4)
    budget = EgoNetSampler(g, cfg, (cfg.fanouts,)).pad_budget(0)
    cache = plan_cache_for(g, cfg, budget, fixed_kernels=FIXED, device="cpu")
    return InferenceServer(g, cfg, res.params, serve_cfg=serve_cfg(),
                           plan_cache=cache, device="cpu", **server_kw)


def test_fixed_plan_cache_commits_its_plan_on_every_miss():
    """Through plan_cache_for(fixed_kernels=FIXED) every miss commits FIXED
    (no selection, no probe) and every batch runs it; a server of the same
    fixed-selector model given no cache selects by cost model, as the
    reference's server does.  (Logits against the reference's server on
    the fixed plan: tests/test_torch_jax_parity.py.)"""
    fixed = fixed_server()
    g, cfg = fixed.ego.graph, fixed.cfg
    chosen = InferenceServer(g, cfg, fixed.params, serve_cfg=serve_cfg(),
                             device="cpu")
    assert chosen.cache.fixed_kernels is None
    nodes = [i * 11 % g.n for i in range(16)]    # the queue limit
    for srv in (fixed, chosen):
        srv.warmup()
        results = drive(srv, [srv.submit(v) for v in nodes])
        assert {s for s, _ in results} == {OK}
        for _, v in results:
            assert np.isfinite(v["logits"]).all()
            assert v["pred"] == int(np.argmax(v["logits"]))
    state = fixed.cache.state_dict()
    assert state["misses"] >= 1 and state["probes"] == 0
    assert {p.layers for _, p, _ in state["entries"]} == {(FIXED, FIXED)}
    assert set(fixed.plan_batches) == {(FIXED, FIXED)}
    assert fixed.n_traces == len(fixed.ego)     # one plan x three rungs
    assert (FIXED, FIXED) not in chosen.plan_batches


def failing_kernel(monkeypatch, name="block_diag_spmm"):
    """Make one kernel wrapper of the fixed plan raise a launch failure;
    returns (the error, its calls)."""
    calls = []
    err = RuntimeError(f"{name} launch failed: CUDA error 700 (an illegal "
                       "memory access was encountered)")

    def failing(*args, **kwargs):
        calls.append(1)
        raise err

    monkeypatch.setattr(ops, name, failing)
    return err, calls


def test_failing_kernel_fails_its_batch_and_is_never_replaced(monkeypatch):
    """A kernel of the committed plan that fails on the request path
    finishes that batch's requests ERROR with its exception, counted in
    ``errors``; no quarantine, no recovery, no other plan, no new record;
    with the kernel sound again the same plan serves the next batch."""
    srv = fixed_server()
    srv.warmup()
    records, t0 = set(srv._infer_fns), srv.n_traces
    plans = {k[0] for k in records}
    with monkeypatch.context() as m:
        err, calls = failing_kernel(m)
        futs = [srv.submit(i * 7 % srv.ego.graph.n) for i in range(8)]
        results = drive(srv, futs)
    assert [s for s, _ in results] == [ERROR] * 8
    assert all(v is err for _, v in results)
    assert len(calls) == 1                     # one batch, one call
    st = srv.stats()
    assert st["errors"] == 8 and st["batches"] == 0
    assert st["quarantined"] == st["recoveries"] == 0
    assert set(srv._infer_fns) == records and srv.n_traces == t0
    state = srv.cache.state_dict()
    assert state["quarantine"] == {} and state["quarantined"] == 0
    assert {p.layers for _, p, _ in state["entries"]} == {(FIXED, FIXED)}
    assert srv.plan_batches == {}
    futs = [srv.submit(i * 7 % srv.ego.graph.n) for i in range(8)]
    assert {s for s, _ in drive(srv, futs)} == {OK}
    assert set(srv.plan_batches) == plans == {(FIXED, FIXED)}
    assert srv.n_traces == t0


def test_warmup_raises_on_a_failing_kernel(monkeypatch):
    srv = fixed_server()
    err, calls = failing_kernel(monkeypatch, "bell_spmm")
    with pytest.raises(RuntimeError) as info:
        srv.warmup()
    assert info.value is err and len(calls) == 1


def test_build_server_and_open_loop_burst_on_the_cpu():
    """launch/serve.py: build_server trains on the CPU and shares its
    PlanCache; an open-loop burst on the background thread terminates
    every future, and stop() leaves no serve-loop thread."""
    srv = launch_serve.build_server("cora", scale=0.1, train_steps=3,
                                    batch_nodes=16, fanouts=(4, 2),
                                    serve_cfg=serve_cfg(queue_limit=64),
                                    device="cpu")
    assert srv.device.type == "cpu" and srv.cache.stats["misses"] >= 1
    srv.warmup()
    with srv:
        futs = launch_serve.open_loop_burst(srv, qps=200, seconds=0.2)
        results = [f.result(timeout=30) for f in futs]
    assert_no_serve_threads()
    assert {s for s, _ in results} <= {OK, SHED, TIMEOUT}
    st = srv.stats()
    assert st["errors"] == 0 and len(futs) == 40
    assert st["admitted"] + st["shed"] == len(futs)
    assert sum(s == OK for s, _ in results) == (st["admitted"]
                                                - st["timeouts"])
