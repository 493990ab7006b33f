"""Thread-aware span tracer with Chrome trace-event JSON export.

Counterpart of ``repro/obs/trace.py`` (pure Python, the same events).

One :class:`Tracer` instance per training run records *spans* (named,
timed intervals) and *instants* attributed to the thread that emitted
them.  The pipeline stages (draw -> build -> resolve -> finish -> device
step), checkpoint writes, and retry backoffs each open a span, so the
async overlap the pipeline claims becomes directly visible: load the
exported file into ``chrome://tracing`` or https://ui.perfetto.dev and
every worker thread gets its own swim lane.

Disabled-path contract: call sites always go through a tracer object, and
the :data:`NULL_TRACER` singleton makes that path near-free — ``span()``
returns one shared no-op context manager (no allocation, no clock read,
no lock).

Recording a span when *enabled* is two ``perf_counter`` reads plus one
locked list append; events are kept as tuples and only formatted into
Chrome trace dicts at :meth:`Tracer.export` time.  Raw OS thread ids are
remapped to small sequential tids at export so the trace is readable,
with ``thread_name`` metadata events carrying the Python thread names
(``pipeline-<sampler>-<i>``, ``ckpt-writer``, ``MainThread``).
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Tracer", "NullTracer", "NULL_TRACER"]


class _Span:
    """Context manager for one timed interval (allocated per span only
    when tracing is enabled)."""
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._record(self.name, self.cat, self.args,
                             self._t0, time.perf_counter())
        return False


class _NullSpan:
    """Shared no-op span: the entire disabled-path cost of ``with
    tracer.span(...)`` is one method call returning this singleton."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans/instants; exports Chrome trace-event JSON."""

    enabled = True

    def __init__(self) -> None:
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        # (name, cat, tid, thread_name, t0, t1_or_None, args); t1 None
        # marks an instant event
        self._events: list[tuple] = []

    # -- recording ----------------------------------------------------------

    def span(self, name: str, cat: str = "host", **args) -> _Span:
        """Context manager timing one interval on the calling thread."""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """Zero-duration marker (quarantine events, slack steps, ...)."""
        t = time.perf_counter()
        with self._lock:
            self._events.append(
                (name, cat, threading.get_ident(),
                 threading.current_thread().name, t, None, args))

    def _record(self, name: str, cat: str, args: dict,
                t0: float, t1: float) -> None:
        tid = threading.get_ident()
        tname = threading.current_thread().name
        with self._lock:
            self._events.append((name, cat, tid, tname, t0, t1, args))

    # -- export -------------------------------------------------------------

    def events(self) -> list[tuple]:
        """Raw event tuples recorded so far (copy)."""
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        """The Chrome trace-event document: complete (``ph: X``) events
        with microsecond ``ts``/``dur`` relative to tracer creation,
        instant (``ph: i``) markers, and one ``thread_name`` metadata
        (``ph: M``) event per thread seen."""
        events = self.events()
        pid = os.getpid()
        tid_map: dict[int, int] = {}
        tid_names: dict[int, str] = {}
        out = []
        for name, cat, raw_tid, tname, t0, t1, args in events:
            tid = tid_map.setdefault(raw_tid, len(tid_map))
            tid_names[tid] = tname
            if t1 is None:
                ev = dict(name=name, cat=cat, ph="i", s="t",
                          ts=(t0 - self._epoch) * 1e6, pid=pid, tid=tid)
            else:
                ev = dict(name=name, cat=cat, ph="X",
                          ts=(t0 - self._epoch) * 1e6,
                          dur=(t1 - t0) * 1e6, pid=pid, tid=tid)
            if args:
                ev["args"] = args
            out.append(ev)
        meta = [dict(name="thread_name", ph="M", pid=pid, tid=tid,
                     args=dict(name=tname))
                for tid, tname in sorted(tid_names.items())]
        return dict(traceEvents=meta + out, displayTimeUnit="ms")

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the path."""
        doc = self.chrome_trace()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path


class NullTracer:
    """Disabled tracer: every operation is a no-op, ``span`` returns one
    shared context manager.  All call sites stay unconditional."""

    enabled = False

    def span(self, name: str, cat: str = "host", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "host", **args) -> None:
        return None

    def events(self) -> list:
        return []

    def chrome_trace(self) -> dict:
        return dict(traceEvents=[], displayTimeUnit="ms")

    def export(self, path: str) -> str:
        raise RuntimeError("cannot export a disabled (null) tracer; "
                           "enable telemetry to record spans")


NULL_TRACER = NullTracer()
