"""Graceful-degradation ladder: fanout rungs with hysteresis.

Counterpart of ``repro/serve/degrade.py``, pure Python like it (the port
keeps its own copy and imports nothing of ``repro``).

Under sustained overload the server steps *down* a rung — a smaller
fanout configuration whose batches are cheaper and whose shapes were
pre-compiled at warmup — trading ego-net receptive field for latency
headroom instead of queuing unboundedly.  When load stays calm it steps
back up.

The transitions are deliberately asymmetric and damped (hysteresis):

* stepping **down** takes ``down_after`` *consecutive* overloaded
  observations — one bursty batch is absorbed by shedding, not by a
  quality change every client sees;
* stepping **up** takes ``up_after`` consecutive calm observations,
  with ``up_after > down_after`` so the ladder reacts fast to pain and
  slowly to relief;
* after any transition a ``cooldown`` of observations is ignored
  entirely, so the post-transition turbulence (queue draining, service
  estimate re-converging) cannot trigger an immediate bounce.

Together these guarantee the no-flapping property the tests pin down: an
alternating overloaded/calm signal never moves the rung, and a square
wave of load produces at most one transition per half-period.
"""
from __future__ import annotations

import threading

__all__ = ["DegradationLadder"]


class DegradationLadder:
    """Current rung index: 0 = full quality, ``n_rungs - 1`` = cheapest."""

    def __init__(self, n_rungs: int, down_after: int = 2,
                 up_after: int = 8, cooldown: int = 4, metrics=None):
        if n_rungs < 1:
            raise ValueError("need at least one rung")
        if up_after <= down_after:
            raise ValueError("hysteresis needs up_after > down_after "
                             f"(got {up_after} <= {down_after})")
        self.n_rungs = int(n_rungs)
        self.down_after = int(down_after)
        self.up_after = int(up_after)
        self.cooldown = int(cooldown)
        self._lock = threading.Lock()
        self._rung = 0
        self._hot = 0      # consecutive overloaded observations
        self._calm = 0     # consecutive calm observations
        self._cool = 0     # observations left to ignore post-transition
        m = metrics
        self._c_down = m.counter("serve.degrades") if m else None
        self._c_up = m.counter("serve.restores") if m else None
        self._g_rung = m.gauge("serve.rung") if m else None

    @property
    def rung(self) -> int:
        return self._rung

    def observe(self, overloaded: bool) -> bool:
        """Feed one load observation (one per served batch); returns True
        iff the rung changed."""
        with self._lock:
            if self._cool > 0:
                self._cool -= 1
                return False
            if overloaded:
                self._hot += 1
                self._calm = 0
            else:
                self._calm += 1
                self._hot = 0
            if overloaded and self._hot >= self.down_after \
                    and self._rung < self.n_rungs - 1:
                self._rung += 1
                self._hot = self._calm = 0
                self._cool = self.cooldown
                if self._c_down:
                    self._c_down.inc()
                if self._g_rung:
                    self._g_rung.set(self._rung)
                return True
            if not overloaded and self._calm >= self.up_after \
                    and self._rung > 0:
                self._rung -= 1
                self._hot = self._calm = 0
                self._cool = self.cooldown
                if self._c_up:
                    self._c_up.inc()
                if self._g_rung:
                    self._g_rung.set(self._rung)
                return True
            return False
