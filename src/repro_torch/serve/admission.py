"""Admission control + deadline-aware micro-batching for the inference
server (serve/server.py).

Counterpart of ``repro/serve/admission.py``, pure Python like it (the
port keeps its own copy and imports nothing of ``repro``).

The queue is the only place load can accumulate, so it is bounded twice
over:

* **capacity shedding** — a full queue rejects at submit time, before the
  request costs anything (no build, no device work, no unbounded memory).
* **predictive shedding** — even with room, a request whose deadline the
  current backlog would already blow is rejected at submit time: serving
  it late helps nobody and steals capacity from requests that can still
  make their deadlines.  The wait estimate comes from the server's EWMA
  service time (``estimate_wait``), so the admission decision tracks the
  device's actual speed, not a static guess.

:meth:`AdmissionController.collect` is the micro-batcher: it blocks for
the first request, then keeps coalescing arrivals into one batch until
either the size target is hit or waiting any longer would eat into the
earliest admitted deadline's service slack — flush on size or deadline,
whichever first.  Requests whose remaining slack can no longer cover one
service time are expired (``timeout``) at collect time rather than
served late; an *admitted* request that makes it into a batch is never
dropped after that point: it finishes ``ok``, or ``error`` with the
exception when its batch fails (this port has no kernel quarantine, so a
failing kernel fails its batch; ROADMAP section 1 item 7).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = ["ServeFuture", "Request", "AdmissionController",
           "PENDING", "OK", "SHED", "TIMEOUT", "ERROR"]

PENDING = "pending"
OK = "ok"          # served; value holds the prediction payload
SHED = "shed"      # rejected at admission (queue full / deadline hopeless)
TIMEOUT = "timeout"  # admitted but expired before a batch could take it
ERROR = "error"    # admitted but the serving path failed permanently


class ServeFuture:
    """One request's completion handle (threading.Event under the hood).

    ``result(timeout)`` blocks until the terminal status lands and
    returns ``(status, value)``; value is the prediction payload for
    ``ok``, an exception for ``error``, None otherwise.  Terminal status
    is set exactly once — late finishers lose silently, so a racing
    expire/serve pair cannot flip an already-delivered result."""

    __slots__ = ("_event", "_lock", "status", "value")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.status = PENDING
        self.value = None

    def finish(self, status: str, value=None) -> bool:
        with self._lock:
            if self.status is not PENDING:
                return False
            self.status, self.value = status, value
        self._event.set()
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        return self.status, self.value


@dataclass
class Request:
    """One admitted ego-net query: seed node + absolute deadline
    (monotonic clock) + its completion future."""
    node: int
    deadline: float                  # absolute, clock() units
    t_submit: float
    future: ServeFuture = field(default_factory=ServeFuture)


class AdmissionController:
    """Bounded FIFO with predictive shedding and deadline-aware flush.

    ``estimate_wait(queue_len)`` returns the expected seconds until a
    request arriving behind ``queue_len`` others reaches the device —
    the server wires this to its EWMA service estimate.  ``clock`` is
    injectable so tests can drive deadlines without real sleeps.
    """

    def __init__(self, limit: int, estimate_wait,
                 clock=time.monotonic, metrics=None):
        if limit < 1:
            raise ValueError(f"queue limit must be >= 1, got {limit}")
        self.limit = int(limit)
        self.estimate_wait = estimate_wait
        self.clock = clock
        self._q: deque[Request] = deque()
        self._cond = threading.Condition()
        m = metrics
        self._c_admit = m.counter("serve.admitted") if m else None
        self._c_shed = m.counter("serve.shed") if m else None
        self._c_expired = m.counter("serve.timeouts") if m else None
        self._h_wait = m.histogram("serve.queue_wait_s") if m else None

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    # -- producer side ------------------------------------------------------

    def submit(self, node: int, deadline_s: float) -> ServeFuture:
        """Admit or shed; never blocks.  A shed future is already done
        (status ``shed``) when it returns — the caller sees the verdict
        immediately instead of waiting out its deadline."""
        now = self.clock()
        fut = ServeFuture()
        with self._cond:
            shed = (len(self._q) >= self.limit
                    or self.estimate_wait(len(self._q)) > deadline_s)
            if not shed:
                self._q.append(Request(node=node, deadline=now + deadline_s,
                                       t_submit=now, future=fut))
                if self._c_admit:
                    self._c_admit.inc()
                self._cond.notify()
        if shed:
            fut.finish(SHED)
            if self._c_shed:
                self._c_shed.inc()
        return fut

    # -- consumer side (the server's batch loop) ----------------------------

    def _expire_front(self, now: float, service_s: float) -> None:
        # under self._cond: drop requests that can no longer be served
        # inside their deadline even if dispatched right now
        while self._q and self._q[0].deadline - now < service_s:
            req = self._q.popleft()
            if req.future.finish(TIMEOUT) and self._c_expired:
                self._c_expired.inc()

    def collect(self, max_n: int, service_s: float,
                stop: threading.Event | None = None,
                poll_s: float = 0.005,
                max_wait_s: float | None = None) -> list[Request]:
        """Coalesce one micro-batch: block until a request arrives, then
        keep gathering until ``max_n`` requests (size flush) or until the
        earliest deadline minus one ``service_s`` arrives (deadline
        flush).  ``max_wait_s`` additionally caps the coalescing wait, so
        a lone request under a generous deadline doesn't idle out most of
        it waiting for company.  Returns [] promptly when ``stop`` is
        set."""
        out: list[Request] = []
        with self._cond:
            while True:
                now = self.clock()
                self._expire_front(now, service_s)
                if self._q:
                    break
                if stop is not None and stop.is_set():
                    return out
                self._cond.wait(timeout=poll_s)
            # flush when waiting longer would eat the earliest admitted
            # request's service slack
            flush_at = self._q[0].deadline - service_s
            if max_wait_s is not None:
                flush_at = min(flush_at, self.clock() + max_wait_s)
            while len(out) < max_n:
                now = self.clock()
                self._expire_front(now, service_s)
                while self._q and len(out) < max_n:
                    out.append(self._q.popleft())
                if (len(out) >= max_n or now >= flush_at
                        or (stop is not None and stop.is_set())):
                    break
                self._cond.wait(timeout=min(poll_s, max(flush_at - now,
                                                        1e-4)))
        if self._h_wait:
            now = self.clock()
            for r in out:
                self._h_wait.observe(now - r.t_submit)
        return out

    def drain(self) -> list[Request]:
        """Pop everything still queued (server shutdown): the caller
        decides their terminal status."""
        with self._cond:
            out = list(self._q)
            self._q.clear()
        return out
