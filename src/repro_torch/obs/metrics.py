"""Thread-safe metrics registry: counters, gauges, bounded histograms.

Counterpart of ``repro/obs/metrics.py`` (pure Python, the same numbers).

Each component creates its instruments from a :class:`MetricsRegistry`
(its own private one by default, the run's shared one when a
``Telemetry`` object is threaded through) and publishes into them; the
dict views (``PlanCache.stats``, ``MinibatchResult.faults``) are
assembled from the registry.

Unlike the tracer and the audit log, the registry is always live (there
is no "disabled" registry): an increment is one lock acquire plus an
add, cheap enough that per-batch bookkeeping never needs gating.  In
CPython ``x += 1`` is *not* atomic across threads (read-modify-write
spans bytecodes), which is exactly the bug class the racing pipeline
workers would hit with bare attributes — every instrument carries its
own lock instead.

Instruments:

* :class:`Counter` — monotonic-ish accumulator (float adds allowed: the
  pipeline's wait-time totals are counters of seconds).  ``set`` exists
  for checkpoint restore.
* :class:`Gauge` — last-value instrument (resume cursor, ladder slack).
* :class:`Histogram` — bounded-window distribution: total count/sum are
  exact forever, percentiles (p50/p99) are computed over the last
  ``window`` observations so memory stays O(window) on long runs.
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    add = inc

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


class Gauge:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


class Histogram:
    """Bounded-window histogram: exact count/sum, windowed percentiles."""
    __slots__ = ("name", "_lock", "_window", "count", "total")

    def __init__(self, name: str, window: int = 1024):
        self.name = name
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=window)
        self.count = 0
        self.total = 0.0

    def observe(self, v) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self._window.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100], over the bounded window (0.0 when empty)."""
        with self._lock:
            xs = sorted(self._window)
        if not xs:
            return 0.0
        i = min(int(round(p / 100.0 * (len(xs) - 1))), len(xs) - 1)
        return float(xs[i])

    def snapshot(self) -> dict:
        with self._lock:
            xs = sorted(self._window)
            count, total = self.count, self.total
        if not xs:
            return dict(count=count, mean=0.0, p50=0.0, p99=0.0, max=0.0)
        at = lambda p: float(xs[min(int(round(p / 100.0 * (len(xs) - 1))),
                                    len(xs) - 1)])
        return dict(count=count, mean=total / max(count, 1),
                    p50=at(50), p99=at(99), max=float(xs[-1]))


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    Creation is locked and idempotent: two racing workers asking for the
    same counter get the same object.  Asking for an existing name with a
    different instrument type raises — a silent re-type would split one
    metric across two objects.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, *args)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        return self._get(name, Histogram, window)

    def snapshot(self) -> dict:
        """{name: value | histogram summary dict}, sorted by name."""
        with self._lock:
            insts = dict(self._instruments)
        out = {}
        for name in sorted(insts):
            inst = insts[name]
            out[name] = (inst.snapshot() if isinstance(inst, Histogram)
                         else inst.value)
        return out
