"""Bounded-queue producer/consumer pipeline for the mini-batch hot path.

Counterpart of ``repro/train/pipeline.py``.  Per-batch host prepare
(sample -> ``decompose_skeleton`` -> PlanCache resolve -> ``fix_shapes``
-> device staging) runs serially with the device step in the synchronous
loop, so one training iteration pays ``compute + prepare``.
:class:`BatchPipeline` runs the prepare on N background threads up to
``prefetch_depth`` batches ahead of the consumer, so a steady-state
iteration pays ``max(compute, prepare)`` instead, as far as the
interpreter lock lets the workers' Python run beside the consumer's.
The fixed-budget padded shapes built in the sampling layer are what make
this safe: every batch of a plan has one shape record, so the only shared
state is the (lock-protected) PlanCache and skeleton bookkeeping.

Determinism contract: per-item work is split into up to three stages, and
the two *stateful* ones run in strictly increasing index order.  Item
``i``'s *draw* (``draw_fn``) runs under one lock in index order: it
consumes sequential sampler state.  ``work_fn`` is the heavy,
order-independent stage and races freely across workers.  The optional
``resolve_fn`` then runs through an index-ordered turnstile: item ``i``'s
resolve starts only after items ``0..i-1`` have finished theirs, so
shared-cache decisions (lookup, selection, LRU order, near-hit aliasing,
slack ladder) are made in exactly the order the sequential loop makes
them.  Completion-order racing is not enough for that: a later-index
batch could otherwise run its lookup before an earlier-index batch
commits the entry it would have hit.  The optional ``finish_fn``
(payload padding, device staging, the step's shape record) races again.
Items are delivered to :meth:`get` in index order.  With samplers whose
per-batch randomness is a pure function of (seed, index) (see
``sampling.sampler.DrawTicket``), the async batch stream and every cache
decision are bit-identical to the sequential ones.

Backpressure is a semaphore with ``prefetch_depth`` permits: a worker takes
a permit before drawing (blocking when ``depth`` batches are staged or in
flight: the queue-full wait) and the consumer returns it on :meth:`get`
(blocking when batch ``i`` is not ready: the queue-empty wait).  Both wait
totals are counters of the run's metrics registry (``pipeline.*``) and
ride :attr:`stats`, and a warning fires once when the ready queue
averages below half of ``prefetch_depth`` (the producers cannot keep up).

Worker exceptions are captured per item and re-raised in the consumer at
that item's :meth:`get` (the pipeline closes itself first); a failed item
vacates its turnstile slot so later items never deadlock behind it.
:meth:`close` is idempotent, joins every worker, and is safe mid-stream,
used directly or through the context manager.

An optional ``retry`` policy (``distributed.fault_tolerance.RetryPolicy``)
re-runs the racing stages, ``work_fn`` and ``finish_fn``, from the same
input on a failure its ``retryable`` classifier accepts; each retry is
counted (``pipeline.retries``).  The draw and the resolve are never
retried: re-running them would replay sequential sampler state and
shared-cache decisions.  The backoff waits on the stop event, so
:meth:`close` mid-backoff joins promptly.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Callable

from repro_torch.obs import Telemetry

__all__ = ["BatchPipeline", "PipelineError"]


def _pipe_counter(key: str):
    """Attribute <-> registry-counter bridge (``pipeline.<key>``): the
    backpressure totals the stats view reports live in the run's metrics
    registry.  Mutating paths already serialize on the pipeline's own
    locks, so the read-modify-write of ``+=`` is safe."""
    def fget(self):
        return self._counters[key].value

    def fset(self, v):
        self._counters[key].set(v)

    return property(fget, fset)


class PipelineError(RuntimeError):
    """Pipeline used after close, or its workers died without output."""


class _Cancelled(BaseException):
    """Internal: unwinds a worker parked on the turnstile at close()."""


class BatchPipeline:
    """Run ``work_fn(index, draw_fn())`` for ``n_items`` items on background
    threads, delivering results to :meth:`get` in index order, at most
    ``prefetch_depth`` items ahead of the consumer.

    ``draw_fn`` consumes sequential sampler state and must be cheap: it runs
    under the pipeline's dispatch lock so draws happen in index order no
    matter which worker wins the race.  ``work_fn`` is the heavy
    order-independent stage (sampler build + skeleton) and runs concurrently
    on up to ``workers`` threads.  ``resolve_fn(index, item)``, if given,
    runs through an index-ordered turnstile: put every shared-state
    decision that must match the sequential loop bit for bit there, and
    keep it cheap (it serializes).  ``finish_fn(index, item)``, if given,
    races again after the resolve (padding, device staging).  ``retry``,
    if given, is a ``RetryPolicy`` whose ``run`` re-runs ``work_fn`` and
    ``finish_fn`` on the failures ``retryable`` accepts; both must be
    safe to re-run from the same input.
    """

    def __init__(self, draw_fn: Callable[[], Any],
                 work_fn: Callable[[int, Any], Any], n_items: int,
                 prefetch_depth: int = 4, workers: int = 2,
                 name: str = "sampler", warn_after: int = 16,
                 resolve_fn: Callable[[int, Any], Any] | None = None,
                 finish_fn: Callable[[int, Any], Any] | None = None,
                 retry: Any = None,
                 retryable: Callable[[BaseException], bool] | None = None,
                 telemetry: Telemetry | None = None):
        # telemetry before the counter-backed attributes below
        self.tele = telemetry if telemetry is not None else Telemetry()
        m = self.tele.metrics
        self._counters = {k: m.counter(f"pipeline.{k}")
                          for k in ("wait_full_s", "wait_empty_s", "retries")}
        # ready-queue depth observed at each get(): its mean drives the
        # starvation warning, p50/p99 ride the metrics snapshot
        self._ready = m.histogram("pipeline.ready_depth")
        self.n_items = int(n_items)
        self.depth = max(int(prefetch_depth), 1)
        # more workers than permits can never run concurrently
        self.workers = max(1, min(int(workers), self.depth))
        self.name = name
        self.warn_after = int(warn_after)
        self._draw_fn = draw_fn
        self._work_fn = work_fn
        self._resolve_fn = resolve_fn
        self._finish_fn = finish_fn
        self._retry = retry
        self._retryable = retryable
        self._slots = threading.Semaphore(self.depth)
        self._draw_lock = threading.Lock()
        self._stat_lock = threading.Lock()
        self._cond = threading.Condition()
        self._results: dict[int, tuple[bool, Any]] = {}   # idx -> (ok, item)
        self._next_draw = 0
        self._next_out = 0
        # index-ordered turnstile for resolve_fn: _next_turn is the index
        # whose resolve may run; finished (or failed/skipped) indices are
        # parked in _turns_done until the sequence catches up to them
        self._turn_cond = threading.Condition()
        self._next_turn = 0
        self._turns_done: set[int] = set()
        self._stop = threading.Event()
        self._closed = False
        self.wait_full_s = 0.0     # producers blocked: every slot staged
        self.wait_empty_s = 0.0    # consumer blocked: next item not ready
        self.retries = 0           # racing-stage retries
        self.starved = False       # warn-once latch (queue below half-full)
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"pipeline-{name}-{i}")
            for i in range(self.workers)]
        self._live = self.workers
        for t in self._threads:
            t.start()

    # registry-backed counters (see _pipe_counter)
    wait_full_s = _pipe_counter("wait_full_s")
    wait_empty_s = _pipe_counter("wait_empty_s")
    retries = _pipe_counter("retries")

    # -- producer side ------------------------------------------------------

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                acquired = self._slots.acquire(timeout=0.05)
                waited = time.perf_counter() - t0
                if self._stop.is_set():
                    if acquired:
                        self._slots.release()
                    return
                if not acquired:
                    with self._draw_lock:
                        drained = self._next_draw >= self.n_items
                    if drained:
                        return             # drained: nothing left to draw
                    with self._stat_lock:  # genuine full-queue backpressure
                        self.wait_full_s += waited
                    continue
                with self._stat_lock:
                    self.wait_full_s += waited
                with self._draw_lock:
                    if self._next_draw >= self.n_items:
                        self._slots.release()
                        return
                    idx = self._next_draw
                    self._next_draw += 1
                    try:
                        # in order under the lock: batch idx's sequential
                        # draw is the single-threaded path's
                        with self.tele.tracer.span("draw", cat="pipeline",
                                                   index=idx):
                            ticket = self._draw_fn()
                    except BaseException as e:   # noqa: BLE001 — propagated
                        self._finish_turn(idx)
                        self._post(idx, False, e)
                        continue
                try:
                    item = self._run_racing(self._work_fn, idx, ticket)
                    if self._resolve_fn is not None:
                        self._await_turn(idx)
                        try:
                            item = self._resolve_fn(idx, item)
                        finally:
                            self._finish_turn(idx)
                    else:
                        self._finish_turn(idx)
                    if self._finish_fn is not None:
                        item = self._run_racing(self._finish_fn, idx, item)
                except _Cancelled:
                    return
                except BaseException as e:       # noqa: BLE001 — propagated
                    self._finish_turn(idx)
                    self._post(idx, False, e)
                else:
                    self._post(idx, True, item)
        finally:
            with self._cond:
                self._live -= 1
                self._cond.notify_all()

    def _run_racing(self, fn, idx: int, item):
        """Run a racing stage, absorbing the failures the retry policy's
        classifier accepts; its backoff waits on the stop event, so
        close() interrupts it."""
        if self._retry is None:
            return fn(idx, item)

        def on_retry(attempt):
            with self._stat_lock:
                self.retries += 1

        return self._retry.run(fn, idx, item, on_retry=on_retry,
                               cancel=self._stop, retryable=self._retryable)

    def _await_turn(self, idx: int) -> None:
        """Block until every lower index has finished its resolve stage."""
        with self.tele.tracer.span("turn_wait", cat="pipeline", index=idx):
            with self._turn_cond:
                while self._next_turn != idx:
                    if self._stop.is_set():
                        raise _Cancelled()
                    self._turn_cond.wait(0.05)

    def _finish_turn(self, idx: int) -> None:
        """Mark ``idx``'s resolve slot done (idempotent, any order): failed
        and skipped items vacate their slot so later turns never wait on a
        resolve that will not happen."""
        with self._turn_cond:
            if idx < self._next_turn or idx in self._turns_done:
                return
            self._turns_done.add(idx)
            while self._next_turn in self._turns_done:
                self._turns_done.discard(self._next_turn)
                self._next_turn += 1
            self._turn_cond.notify_all()

    def _post(self, idx: int, ok: bool, payload: Any) -> None:
        with self._cond:
            self._results[idx] = (ok, payload)
            self._cond.notify_all()

    # -- consumer side ------------------------------------------------------

    def get(self, timeout: float | None = None) -> Any:
        """Next item, in index order; blocks until its worker finishes (at
        most ``timeout`` seconds, then raises :class:`PipelineError`).
        Re-raises the worker's exception (closing the pipeline) if that
        item failed."""
        if self._closed:
            raise PipelineError(f"pipeline {self.name!r} is closed")
        if self._next_out >= self.n_items:
            raise PipelineError(
                f"pipeline {self.name!r} already delivered all "
                f"{self.n_items} items")
        with self._cond:
            self._ready.observe(len(self._results))
            t0 = time.perf_counter()
            while self._next_out not in self._results:
                if self._live == 0:
                    raise PipelineError(
                        f"all pipeline {self.name!r} workers exited before "
                        f"item {self._next_out} was produced")
                if (timeout is not None
                        and time.perf_counter() - t0 > timeout):
                    raise PipelineError(
                        f"pipeline {self.name!r}: item {self._next_out} "
                        f"not ready within {timeout} s")
                self._cond.wait(0.1)
            self.wait_empty_s += time.perf_counter() - t0
            ok, payload = self._results.pop(self._next_out)
            self._next_out += 1
        self._slots.release()
        self._maybe_warn()
        if not ok:
            self.close()
            raise payload
        return payload

    def _maybe_warn(self) -> None:
        if self.starved or self._ready.count < self.warn_after:
            return
        mean_ready = self._ready.mean
        if mean_ready < self.depth / 2:
            self.starved = True
            warnings.warn(
                f"pipeline {self.name!r}: prefetch queue averaged "
                f"{mean_ready:.1f}/{self.depth} ready batches — "
                f"{self.workers} worker(s) can't keep it half-full; raise "
                f"pipeline_workers (or prefetch_depth) or accept "
                f"prepare-bound steps", RuntimeWarning, stacklevel=3)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Idempotent shutdown: stop workers, join them, drop staged items.
        Safe mid-stream; after close, :meth:`get` raises."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for _ in self._threads:     # unblock producers parked on the queue
            self._slots.release()
        with self._turn_cond:       # and those parked on the turnstile
            self._turn_cond.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)
        with self._cond:
            self._results.clear()
            self._cond.notify_all()

    def __enter__(self) -> "BatchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def stats(self) -> dict:
        """Backpressure counters for MinibatchResult and logs, assembled
        from the run's metrics registry (the instruments the telemetry
        snapshot exports), the reference's keys."""
        return dict(depth=self.depth, workers=self.workers,
                    delivered=self._next_out,
                    wait_full_s=self.wait_full_s,
                    wait_empty_s=self.wait_empty_s,
                    ready_mean=self._ready.mean,
                    starved=self.starved, retries=self.retries)
