"""The port's retries and deterministic fault injection
(distributed/fault_tolerance.py) wired into mini-batch training
(train/gnn_steps.py, train/pipeline.py), on the CPU, torch and numpy
only: the reference's tests/test_fault_tolerance.py (transient retries
absorbed bit-identically, retries exhausted, fatal faults failing fast,
shutdown under retry, the non-finite guard, crash/resume through
``FaultPlan(crash_at=)``, the FaultPlan state machine, attribution through
the cause chain), the liveness and retry checks of tests/test_distributed.py
and the jitter checks of tests/test_serving.py, case for case; then the
port's own: a kernel failure is fatal with zero retries, and injected
kernel faults (kernel quarantine) raise naming the ROADMAP item.  Parity
with the reference's FaultPlan runs is in tests/test_torch_jax_parity.py.
Every wait is bounded and every test ends with no worker thread alive."""
import torch_parity as tp  # noqa: F401,I001  (first: pins torch to one thread)

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.distributed import fault_tolerance as ft
from repro_torch.kernels import ops
from repro_torch.obs import Telemetry
from repro_torch.train import gnn_steps
from repro_torch.train.pipeline import BatchPipeline
from test_torch_checkpoint import assert_no_worker_threads, assert_resumed_equal
from test_torch_pipeline import cfg_of, small_graph


def train(cfg, steps, **kw):
    return gnn_steps.train_minibatch(small_graph(), cfg, steps=steps,
                                     device="cpu", **kw)


def run_result_equal(a, b):
    assert a.losses == b.losses
    assert a.hit_history == b.hit_history
    assert a.plans == b.plans
    assert a.plan_history == b.plan_history
    assert a.cache == b.cache


# -- crash-safe checkpoint / resume through FaultPlan(crash_at=) --------------

@pytest.mark.parametrize("prefetch", [0, 3], ids=["sync", "async"])
def test_crash_resume_bit_identical(prefetch, tmp_path):
    """A crash injected after batch 7 commits (checkpoint every 3): the
    resumed run's loss curve, hits, plans, cache counters and params are
    the uninterrupted run's, and the crash leaked no worker thread."""
    cfg = cfg_of(prefetch_depth=prefetch, pipeline_workers=2, seed=7)
    ref = train(cfg, 10, eval_batches=2)
    ck = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path),
                             checkpoint_every=3)
    fp = ft.FaultPlan(crash_at=7)
    with pytest.raises(ft.SimulatedCrash):
        train(ck, 10, eval_batches=0, fault_plan=fp)
    assert_no_worker_threads()
    res = train(dataclasses.replace(ck, resume_from=str(tmp_path)), 10,
                eval_batches=2)
    # the crash after batch 7 -> the last checkpoint is the one after 5
    assert res.faults["resumed_at"] == 6
    assert_resumed_equal(res, ref)
    assert_no_worker_threads()


def test_resume_at_checkpoint_free_index_replays_everything(tmp_path):
    cfg = cfg_of(seed=7)
    ref = train(cfg, 6, eval_batches=1)
    ck = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path),
                             checkpoint_every=4, resume_from=str(tmp_path))
    with pytest.raises(ft.SimulatedCrash):
        train(dataclasses.replace(ck, resume_from=""), 6, eval_batches=0,
              fault_plan=ft.FaultPlan(crash_at=2))
    with pytest.warns(UserWarning, match="no valid checkpoint"):
        res = train(ck, 6, eval_batches=1)
    assert res.faults["resumed_at"] == -1
    assert_resumed_equal(res, ref)


# -- transient retry ------------------------------------------------------------

def test_transient_worker_faults_retried_bit_identically():
    """Two injected transient faults on one batch: the pipeline absorbs
    them with backoff and the run is the fault-free run's (the injection
    precedes the skeleton, so no cache sees an aborted attempt)."""
    cfg = cfg_of(prefetch_depth=3, pipeline_workers=2)
    ref = train(cfg, 8, eval_batches=1)
    fp = ft.FaultPlan(worker_faults={2: 2})
    res = train(dataclasses.replace(cfg, retry_max=3, retry_base_delay_s=0.0),
                8, eval_batches=1, fault_plan=fp)
    assert res.faults["retries"] == 2
    assert fp.injected_worker == 2
    assert res.pipeline["retries"] == 2
    run_result_equal(res, ref)
    assert res.n_traces == ref.n_traces
    assert (res.skeleton_hits, res.skeleton_misses) == (
        ref.skeleton_hits, ref.skeleton_misses)
    assert_no_worker_threads()


def test_retries_exhausted_propagates_the_fault():
    cfg = cfg_of(prefetch_depth=2, pipeline_workers=2, retry_max=2,
                 retry_base_delay_s=0.0)
    fp = ft.FaultPlan(worker_faults={1: 5})   # more faults than retries
    with pytest.raises(ft.InjectedWorkerFault):
        train(cfg, 4, eval_batches=0, fault_plan=fp)
    assert fp.injected_worker == 3            # the first try and 2 retries
    assert_no_worker_threads()


@pytest.mark.parametrize("prefetch", [0, 2], ids=["sync", "async"])
def test_fatal_fault_fails_fast_despite_retry_budget(prefetch):
    cfg = cfg_of(prefetch_depth=prefetch, pipeline_workers=2, retry_max=5,
                 retry_base_delay_s=10.0)   # a retry would hang the test
    fp = ft.FaultPlan(fatal_at={1})
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="fatal"):
        train(cfg, 4, eval_batches=0, fault_plan=fp)
    assert time.perf_counter() - t0 < 5.0    # no backoff was paid
    assert fp.injected_fatal == 1
    assert_no_worker_threads()


def test_sync_path_retries_too():
    ref = train(cfg_of(), 6, eval_batches=1)
    fp = ft.FaultPlan(worker_faults={0: 1, 3: 1})
    res = train(cfg_of(retry_max=3, retry_base_delay_s=0.0), 6,
                eval_batches=1, fault_plan=fp)
    assert res.faults["retries"] == 2
    assert res.pipeline is None
    run_result_equal(res, ref)


def test_shutdown_under_retry_joins_promptly():
    """close() mid-backoff interrupts the retry ladder: the stop event is
    the backoff's timer."""
    def work(idx, ticket):
        raise ft.TransientError(f"flaky {idx}")

    counter = iter(range(100))
    pipe = BatchPipeline(lambda: next(counter), work, n_items=8,
                         prefetch_depth=2, workers=2,
                         retry=ft.RetryPolicy(max_retries=50,
                                              base_delay_s=30.0),
                         retryable=ft.default_transient)
    time.sleep(0.1)          # let the workers enter their first backoff
    t0 = time.perf_counter()
    pipe.close()
    assert time.perf_counter() - t0 < 5.0
    assert pipe.stats["retries"] >= 1
    assert_no_worker_threads()


def test_concurrent_retries_lose_no_count():
    """16 workers racing over 200 items, each of whose build fails once
    (FaultPlan.on_built), at a 1 us switch interval: every injected fault
    is counted once and retried once, and every item is delivered."""
    n = 200
    fp = ft.FaultPlan(worker_faults={i: 1 for i in range(n)})
    counter = iter(range(10 * n))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with BatchPipeline(lambda: next(counter),
                           lambda i, t: fp.on_built(i, t), n_items=n,
                           prefetch_depth=16, workers=16, warn_after=n + 1,
                           retry=ft.RetryPolicy(max_retries=1,
                                                base_delay_s=0.0),
                           retryable=ft.default_transient) as pipe:
            out = [pipe.get(timeout=30.0) for _ in range(n)]
    finally:
        sys.setswitchinterval(old)
    assert out == list(range(n))
    assert fp.injected_worker == n
    assert pipe.stats["retries"] == n
    assert_no_worker_threads()


# -- non-finite guard -------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 3], ids=["sync", "async"])
def test_nonfinite_guard_skips_and_counts(prefetch):
    """A NaN batch adds a NaN loss but no update: training goes on from
    the pre-batch params and every later loss is finite."""
    cfg = cfg_of(prefetch_depth=prefetch, pipeline_workers=2)
    ref = train(cfg, 8, eval_batches=1)
    fp = ft.FaultPlan(nonfinite_at=[3])
    res = train(cfg, 8, eval_batches=1, fault_plan=fp)
    assert fp.injected_nonfinite == 1
    assert res.faults["nonfinite_skips"] == 1
    assert res.losses[:3] == ref.losses[:3]
    assert not np.isfinite(res.losses[3])
    assert np.isfinite(res.losses[4:]).all()
    assert res.plan_history == ref.plan_history


def test_nonfinite_without_guard_poisons_params():
    fp = ft.FaultPlan(nonfinite_at=[2])
    res = train(cfg_of(nonfinite_guard=False), 6, eval_batches=0,
                fault_plan=fp)
    assert res.faults["nonfinite_skips"] == 0
    # NaN gradients flowed into Adam: every loss from the hit on is NaN
    assert not np.isfinite(res.losses[2:]).any()


# -- the FaultPlan harness --------------------------------------------------------

def test_fault_plan_is_reusable_state_machine():
    fp = ft.FaultPlan(worker_faults={4: 2}, nonfinite_at=[1])
    batch = None
    with pytest.raises(ft.InjectedWorkerFault):
        fp.on_built(4, batch)
    with pytest.raises(ft.InjectedWorkerFault):
        fp.on_built(4, batch)
    assert fp.on_built(4, batch) is batch    # budget spent -> clean
    assert fp.injected_worker == 2
    fp.on_committed(3)                       # no crash configured
    assert fp.injected_fatal == 0


def test_fault_kernel_attribution_walks_cause_chain():
    inner = ft.KernelFault("__fault_kernel__:bell injected")
    try:
        try:
            raise inner
        except ft.KernelFault as k:
            raise RuntimeError("launch wrapped") from k
    except RuntimeError as outer:
        assert ft.fault_kernel_from(outer) == "bell"
    assert ft.fault_kernel_from(RuntimeError("unrelated")) is None


# -- liveness and retry policy (tests/test_distributed.py) ------------------------

def test_heartbeat_dead_host():
    hb = ft.HeartbeatMonitor(timeout_s=10)
    hb.beat(0, now=0.0)
    hb.beat(1, now=0.0)
    hb.beat(0, now=8.0)
    assert hb.dead_hosts(now=15.0) == [1]
    assert hb.alive_hosts(now=15.0) == [0]


def test_straggler_detection():
    det = ft.StragglerDetector(threshold=1.5, min_samples=3)
    for _ in range(5):
        for h in range(4):
            det.observe(h, 1.0 if h != 2 else 3.0)
    assert det.stragglers() == [2]


def test_reassign_deterministic_and_complete():
    m1 = ft.reassign_shards(16, [0, 1, 3])
    m2 = ft.reassign_shards(16, [3, 0, 1])   # order must not matter
    assert m1 == m2
    covered = sorted(s for ss in m1.values() for s in ss)
    assert covered == list(range(16))


def test_retry_policy():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    pol = ft.RetryPolicy(max_retries=5, base_delay_s=0)
    assert pol.run(flaky, _sleep=lambda s: None) == "ok"
    assert len(calls) == 3


def test_heartbeat_prune_after_report():
    hb = ft.HeartbeatMonitor(timeout_s=10)
    hb.beat(0, now=0.0)
    hb.beat(1, now=0.0)
    hb.beat(2, now=0.0)
    assert hb.dead_hosts(now=20.0, prune=True) == [0, 1, 2]
    assert hb.dead_hosts(now=25.0) == []         # pruned, not re-reported
    hb.beat(1, now=26.0)                         # registers afresh
    assert hb.alive_hosts(now=27.0) == [1]
    hb.forget(1)
    assert hb.dead_hosts(now=100.0) == []
    assert hb.alive_hosts(now=27.0) == []


def test_retry_policy_fatal_fails_fast():
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("deterministic bug")

    pol = ft.RetryPolicy(max_retries=5, base_delay_s=0)
    with pytest.raises(ValueError):
        pol.run(broken, _sleep=lambda s: None,
                retryable=ft.default_transient)
    assert len(calls) == 1                       # no retry burned


def test_retry_policy_cancel_interrupts_backoff():
    cancel = threading.Event()

    def flaky():
        cancel.set()                             # close() arrives mid-run
        raise ft.TransientError("flaky")

    pol = ft.RetryPolicy(max_retries=10, base_delay_s=30.0)
    t0 = time.perf_counter()
    with pytest.raises(ft.TransientError):
        pol.run(flaky, cancel=cancel, retryable=ft.default_transient)
    assert time.perf_counter() - t0 < 5.0


# -- decorrelated jitter (tests/test_serving.py) ------------------------------------

def test_retry_jitter_deterministic_and_decorrelated():
    mk = lambda: ft.RetryPolicy(max_retries=4, base_delay_s=0.01,  # noqa: E731
                                jitter=True, seed=11, max_delay_s=0.08)
    a, b = mk(), mk()
    s0, s1 = a.delays(), a.delays()
    assert s0 == b.delays()              # call N is a pure function of seed
    assert s1 == b.delays()
    assert s0 != s1                      # concurrent calls decorrelate
    assert all(0.01 <= d <= 0.08 for d in s0 + s1)
    waits, calls = [], dict(n=0)

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise ft.TransientError("boom")
        return "done"

    c = mk()
    expect = mk().delays()
    assert c.run(flaky, _sleep=waits.append) == "done"
    assert waits == expect[:3]


def test_retry_without_jitter_unchanged():
    p = ft.RetryPolicy(max_retries=3, base_delay_s=1.0, backoff=2.0)
    assert p.delays() == [1.0, 2.0, 4.0]
    assert p.delays() == [1.0, 2.0, 4.0]   # no hidden state without jitter
    p2 = ft.RetryPolicy(max_retries=3, base_delay_s=1.0, backoff=2.0,
                        max_delay_s=1.5)
    assert p2.delays() == [1.0, 1.5, 1.5]


# -- the port's own -----------------------------------------------------------------

def test_retry_backoff_spans_on_the_tracer():
    """Each backoff wait is one "retry.backoff" span (cat "fault") with
    its attempt and delay, on the tracer the policy was given."""
    tele = Telemetry(enabled=True)
    calls = dict(n=0)

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ft.TransientError("boom")
        return "ok"

    pol = ft.RetryPolicy(max_retries=3, base_delay_s=0.001,
                         tracer=tele.tracer)
    assert pol.run(flaky, retryable=ft.default_transient) == "ok"
    spans = [e for e in tele.tracer.events() if e[0] == "retry.backoff"]
    assert [(e[1], e[6]) for e in spans] == [
        ("fault", dict(attempt=0, delay_s=0.001)),
        ("fault", dict(attempt=1, delay_s=0.002))]


@pytest.mark.parametrize("prefetch", [0, 3], ids=["sync", "async"])
def test_kernel_failure_fails_at_once_with_zero_retries(prefetch,
                                                        monkeypatch):
    """A kernel function that raises RuntimeError (a launch failure) ends
    the run with that error through a retry budget of 3: no retry, no
    other plan, no second call of the kernel."""
    calls = []
    err = RuntimeError("block_diag_spmm launch failed: CUDA error 700 "
                       "(an illegal memory access was encountered)")

    def failing(*args, **kwargs):
        calls.append(1)
        raise err

    monkeypatch.setattr(ops, "block_diag_spmm", failing)
    cfg = cfg_of(prefetch_depth=prefetch, pipeline_workers=2, retry_max=3,
                 retry_base_delay_s=10.0, selector="fixed",
                 fixed_kernels=("block_diag", "bell"))
    tele = Telemetry()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as info:
        train(cfg, 6, eval_batches=0, telemetry=tele,
              fault_plan=ft.FaultPlan(worker_faults={4: 1}))
    assert time.perf_counter() - t0 < 5.0
    assert info.value is err
    assert len(calls) == 1
    assert tele.metrics.counter("faults.retries").value == 0
    assert tele.metrics.counter("pipeline.retries").value == 0
    assert_no_worker_threads()


def test_stateful_failures_are_never_retried():
    """:func:`gnn_steps._fatal` turns a failure that default_transient
    would retry (an OSError: a kernel library that does not load) into a
    RuntimeError, so the retried unit fails at once."""
    calls = []

    def load():
        calls.append(1)
        with gnn_steps._fatal("loading the GNN kernel libraries"):
            raise OSError("libbell_spmm.so: cannot open shared object file")

    pol = ft.RetryPolicy(max_retries=3, base_delay_s=10.0)
    with pytest.raises(RuntimeError, match="loading the GNN kernel") as info:
        pol.run(load, retryable=ft.default_transient)
    assert len(calls) == 1
    assert isinstance(info.value.__cause__, OSError)
    with pytest.raises(ValueError):            # not transient: unchanged
        with gnn_steps._fatal("staging the batch"):
            raise ValueError("shape")


def test_kernel_faults_raise_naming_the_roadmap():
    fp = ft.FaultPlan(kernel_faults={"bell": "execute"})
    with pytest.raises(NotImplementedError, match="ROADMAP section 1 item 7"):
        fp.activate()
    with pytest.raises(NotImplementedError, match="ROADMAP section 1 item 7"):
        train(cfg_of(), 2, eval_batches=0, fault_plan=fp)
    plain = ft.FaultPlan()
    with plain.activate() as active:          # patches nothing
        assert active is plain
        res = train(cfg_of(), 2, eval_batches=0, fault_plan=plain)
    assert res.faults["retries"] == 0 and len(res.losses) == 2
    assert_no_worker_threads()
