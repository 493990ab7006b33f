"""Fault tolerance for the training loops: liveness, retries, fault injection.

Counterpart of ``repro/distributed/fault_tolerance.py``, host code only
(numpy and the standard library), with the reference's semantics and
defaults:

  HeartbeatMonitor  -- per-host liveness with a timeout -> dead-host set;
                       reported dead hosts can be pruned so a long-dead
                       host is not reported again on every poll
  StragglerDetector -- per-host step-time EWMA; a host whose smoothed step
                       time exceeds ``threshold`` x the fleet median is a
                       straggler
  reassign_shards   -- deterministic data-shard reassignment when hosts
                       die (a pure function of (n_shards, alive hosts))
  RetryPolicy       -- bounded backoff retries of transient failures: an
                       exponential ladder or decorrelated jitter (one rng
                       stream per ``run()`` call, the reference's delays
                       number for number), an interruptible backoff (the
                       ``cancel`` event) and a fatal-vs-transient
                       classifier (``retryable``)
  TransientError /
  default_transient -- the marker and the default classifier the
                       mini-batch loop retries by
  FaultPlan         -- deterministic fault injection keyed by batch index:
                       transient worker faults, fatal faults, non-finite
                       batches and simulated crashes

What is fatal.  The mini-batch loop (``train/gnn_steps.py``) classifies
by :func:`default_transient` and nothing wider: a CUDA kernel that fails
to build or launch raises ``RuntimeError`` and is never retried, never
routed to another plan and never replaced by its plain version; so is
``torch.OutOfMemoryError``.

Not ported:

* kernel quarantine (ROADMAP section 1 item 7's next slice): the
  reference's ``FaultPlan.activate`` patches the kernel registry so the
  kernels named in ``kernel_faults`` fail, and its loop quarantines them
  and degrades to the next plan.  Here ``kernel_faults`` stays a field,
  :class:`KernelFault` and :func:`fault_kernel_from` are host data, as
  the PlanCache's quarantine map is, and a plan with ``kernel_faults``
  raises ``NotImplementedError`` from :meth:`FaultPlan.activate` and
  from ``train_minibatch``.
* ``drain_effect_tokens``: it clears JAX's poisoned runtime effect tokens
  after an aborted dispatch; a CUDA stream has no such tokens.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["HeartbeatMonitor", "StragglerDetector", "reassign_shards",
           "TransientError", "default_transient", "RetryPolicy",
           "SimulatedCrash", "InjectedWorkerFault", "KernelFault",
           "fault_kernel_from", "FaultPlan", "KERNEL_QUARANTINE_UNPORTED"]

KERNEL_QUARANTINE_UNPORTED = (
    "FaultPlan.kernel_faults (injected kernel failures, kernel quarantine "
    "and the step's degrade to the next plan) is not ported yet: ROADMAP "
    "section 1 item 7")


@dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    _last: dict = field(default_factory=dict)

    def beat(self, host: int, now: float | None = None) -> None:
        self._last[host] = time.monotonic() if now is None else now

    def forget(self, host: int) -> None:
        """Drop a host from liveness tracking (replaced, drained, or its
        death handled) so :meth:`dead_hosts` stops reporting it.  A later
        :meth:`beat` registers it afresh."""
        self._last.pop(host, None)

    def dead_hosts(self, now: float | None = None,
                   prune: bool = False) -> list[int]:
        """Hosts whose last beat is older than ``timeout_s``.  With
        ``prune=True`` the reported hosts are forgotten in the same call
        (report once)."""
        now = time.monotonic() if now is None else now
        dead = sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)
        if prune:
            for h in dead:
                self.forget(h)
        return dead

    def alive_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout_s)


@dataclass
class StragglerDetector:
    """EWMA step time per host; a host is a straggler when its smoothed
    step time exceeds ``threshold`` x the fleet median."""
    alpha: float = 0.2
    threshold: float = 1.5
    min_samples: int = 3
    _ewma: dict = field(default_factory=dict)
    _count: dict = field(default_factory=dict)

    def observe(self, host: int, step_seconds: float) -> None:
        prev = self._ewma.get(host)
        self._ewma[host] = (step_seconds if prev is None
                            else self.alpha * step_seconds
                            + (1 - self.alpha) * prev)
        self._count[host] = self._count.get(host, 0) + 1

    def stragglers(self) -> list[int]:
        ready = {h: t for h, t in self._ewma.items()
                 if self._count[h] >= self.min_samples}
        if len(ready) < 2:
            return []
        med = sorted(ready.values())[len(ready) // 2]
        return sorted(h for h, t in ready.items() if t > self.threshold * med)


def reassign_shards(n_shards: int,
                    alive_hosts: list[int]) -> dict[int, list[int]]:
    """Deterministic shard -> host map: shard i goes to the i-th alive host
    (sorted) modulo their count, so hosts agree without communicating."""
    assert alive_hosts, "no hosts alive"
    hosts = sorted(alive_hosts)
    out: dict[int, list[int]] = {h: [] for h in hosts}
    for s in range(n_shards):
        out[hosts[s % len(hosts)]].append(s)
    return out


# -- transient-vs-fatal classification ----------------------------------------

class TransientError(RuntimeError):
    """Marker for failures worth retrying (flaky I/O, injected worker
    faults).  Anything not classified transient fails fast: retrying a
    deterministic exception repeats it and hides the first stack trace."""


def default_transient(exc: BaseException) -> bool:
    """The mini-batch loop's retry classifier: the explicit marker plus
    the OS-level failure classes that are environmental."""
    return isinstance(exc, (TransientError, OSError, TimeoutError,
                            ConnectionError))


@dataclass
class RetryPolicy:
    max_retries: int = 3
    base_delay_s: float = 1.0
    backoff: float = 2.0
    # decorrelated jitter: each wait draws uniform(base, 3 * previous
    # wait), capped at max_delay_s, so callers that failed together do not
    # retry in lockstep.  Off by default (the plain exponential ladder);
    # with it on, the Nth run() call on this policy draws from stream
    # (seed, N), a pure function of call order
    jitter: bool = False
    max_delay_s: float | None = None
    seed: int | None = None
    # optional obs tracer: each backoff wait records a "retry.backoff" span
    # (cat "fault") on the waiting thread
    tracer: object = None
    _run_count: int = field(default=0, init=False, repr=False,
                            compare=False)
    _count_lock: threading.Lock = field(default_factory=threading.Lock,
                                        init=False, repr=False,
                                        compare=False)

    @staticmethod
    def _wait(delay: float, _sleep, cancel) -> bool:
        """Wait out one backoff step; True when ``cancel`` was set."""
        if _sleep is not None:
            _sleep(delay)
            return False
        if cancel is not None:
            return cancel.wait(delay)
        time.sleep(delay)
        return False

    def _jitter_rng(self) -> np.random.Generator:
        """One rng stream per run() call: stream i belongs to the i-th
        call, whatever thread makes it; fresh OS entropy without seed."""
        with self._count_lock:
            i = self._run_count
            self._run_count += 1
        if self.seed is None:
            return np.random.default_rng()
        return np.random.default_rng(np.random.SeedSequence((self.seed, i)))

    def delays(self, rng: np.random.Generator | None = None) -> list[float]:
        """The backoff ladder one ``run()`` would wait: plain exponential
        without jitter, decorrelated-jitter draws with it (``rng`` picks
        the stream; by default the next call's)."""
        cap = (self.max_delay_s if self.max_delay_s is not None
               else self.base_delay_s * self.backoff ** self.max_retries)
        if self.jitter and rng is None:
            rng = self._jitter_rng()
        out, delay = [], self.base_delay_s
        for _ in range(self.max_retries):
            if self.jitter:
                delay = min(cap, float(rng.uniform(self.base_delay_s,
                                                   3.0 * delay)))
                out.append(delay)
            else:
                out.append(min(delay, cap))
                delay *= self.backoff
        return out

    def run(self, fn, *args, on_retry=None, _sleep=None, cancel=None,
            retryable=None, **kwargs):
        """Call ``fn(*args, **kwargs)`` with bounded backoff retries.

        ``retryable(exc) -> bool`` classifies failures; a failure it
        rejects re-raises at once.  ``cancel`` (a ``threading.Event``) is
        the backoff's timer: once set, the failure re-raises instead of
        waiting out the ladder.  ``on_retry(attempt)`` runs before each
        wait; ``_sleep`` replaces the wait (tests)."""
        ladder = iter(self.delays())
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if attempt == self.max_retries:
                    raise
                if retryable is not None and not retryable(exc):
                    raise
                if cancel is not None and cancel.is_set():
                    raise
                if on_retry is not None:
                    on_retry(attempt)
                delay = next(ladder)
                span = (self.tracer.span("retry.backoff", cat="fault",
                                         attempt=attempt, delay_s=delay)
                        if self.tracer is not None
                        else contextlib.nullcontext())
                with span:
                    cancelled = self._wait(delay, _sleep, cancel)
                if cancelled:
                    raise


# -- deterministic fault injection ----------------------------------------------

class SimulatedCrash(RuntimeError):
    """Raised by :class:`FaultPlan` after the chosen batch commits: the
    process 'dies' with its checkpoint on disk, and the resumed run must
    reproduce the uninterrupted one."""


class InjectedWorkerFault(TransientError):
    """Transient worker failure injected into the batch-build stage."""


class KernelFault(RuntimeError):
    """An injected kernel failure, attributed by its message's marker.
    Host data only here: nothing in the port raises it yet."""


# the marker an injected kernel failure carries, so a failure can be
# attributed to one kernel through any exception wrapping
_KERNEL_FAULT_MARK = "__fault_kernel__"
_KERNEL_FAULT_RE = re.compile(_KERNEL_FAULT_MARK + r":(\w+)")


def fault_kernel_from(exc: BaseException) -> str | None:
    """The kernel named by an injected-fault marker anywhere in the
    exception's cause/context chain, or None."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        m = _KERNEL_FAULT_RE.search(str(exc))
        if m:
            return m.group(1)
        exc = exc.__cause__ or exc.__context__
    return None


@dataclass
class FaultPlan:
    """Deterministic fault schedule for one training run, keyed by global
    batch index, so it replays identically under any pipeline depth,
    worker count or retry schedule.

      worker_faults -- batch index -> how many times that batch's build
                       raises :class:`InjectedWorkerFault` (transient: the
                       retries absorb them)
      fatal_at      -- batch indices whose build raises ValueError once
                       (not transient: fails fast through any retry budget)
      kernel_faults -- kernel name -> "compile" | "execute" in the
                       reference; not ported (the module docstring): a
                       non-empty map raises NotImplementedError
      nonfinite_at  -- batch indices whose features become NaN (the
                       non-finite guard must skip the update)
      crash_at      -- batch index after whose commit the loop raises
                       :class:`SimulatedCrash` (None: never)
    """
    worker_faults: dict = field(default_factory=dict)
    fatal_at: frozenset | set = field(default_factory=set)
    kernel_faults: dict = field(default_factory=dict)
    nonfinite_at: frozenset | set = field(default_factory=set)
    crash_at: int | None = None
    # counters, observable by tests and scripts
    injected_worker: int = 0
    injected_fatal: int = 0
    injected_nonfinite: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    _pending: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._pending = dict(self.worker_faults)
        self._fatal_pending = set(self.fatal_at)

    def on_built(self, index: int, batch):
        """Called after batch ``index``'s sampler build, on whatever thread
        built it.  May raise (a fatal or a worker fault) or return the
        batch with NaN features; retries re-enter here, so the failure
        counts are consumed under the lock."""
        with self._lock:
            if index in self._fatal_pending:
                self._fatal_pending.discard(index)
                self.injected_fatal += 1
                raise ValueError(
                    f"injected fatal (non-transient) fault at batch {index}")
            left = self._pending.get(index, 0)
            if left > 0:
                self._pending[index] = left - 1
                self.injected_worker += 1
                raise InjectedWorkerFault(
                    f"injected transient worker fault at batch {index} "
                    f"({left - 1} left)")
            if index in self.nonfinite_at:
                self.injected_nonfinite += 1
                batch = dataclasses.replace(
                    batch, features=np.full_like(batch.features, np.nan))
        return batch

    def on_committed(self, index: int) -> None:
        """Called after batch ``index``'s update committed and any due
        checkpoint was scheduled: the simulated kill point."""
        if self.crash_at is not None and index == self.crash_at:
            raise SimulatedCrash(f"injected crash after batch {index}")

    def activate(self):
        """Context manager around the training call.  With
        ``kernel_faults`` empty it patches nothing and yields the plan;
        otherwise it raises NotImplementedError (kernel quarantine is not
        ported)."""
        if self.kernel_faults:
            raise NotImplementedError(KERNEL_QUARANTINE_UNPORTED)
        return contextlib.nullcontext(self)
