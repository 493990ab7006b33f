"""Telemetry of the sampler -> PlanCache -> kernel path.

Counterpart of ``repro/obs/__init__.py``, pure Python like it.  Three
instruments, one facade:

* :mod:`repro_torch.obs.trace` — a thread-aware span tracer over the
  mini-batch loop's stages (sample -> build -> resolve -> finish -> device
  step), exported as Chrome trace-event JSON (``chrome://tracing`` /
  Perfetto).
* :mod:`repro_torch.obs.metrics` — a thread-safe registry of counters,
  gauges and bounded histograms (p50/p99).  The PlanCache and the
  mini-batch loop publish their counters into it; the dict views
  (``PlanCache.stats``, ``MinibatchResult.cache`` and ``faults``) are
  assembled from the registry.
* :mod:`repro_torch.obs.audit` — the selector audit log: every committed
  plan with its per-(layer, tier) kernel choices and modeled costs, probe
  measurements, quarantine events, observed step times, and a cost-model
  calibration report (per-kernel predicted-vs-measured error) surfaced
  through ``MinibatchResult.telemetry``.

The :class:`Telemetry` facade bundles the three.  ``Telemetry(enabled=
False)``, the default everywhere, carries the real metrics registry (its
counters are the system of record for the stats views) but the null
tracer and null audit, whose methods are no-ops returning shared
singletons, so call sites stay unconditional.  Telemetry never feeds back
into decisions: tracing and auditing are append-only, so enabling them
leaves losses, plans, hit history and trace counts bit-identical.

Logging: :func:`get_logger` / :func:`enable_verbose` give the training
stack a namespaced ``repro_torch.train`` logger; ``verbose=True`` on the
drivers installs a plain stdout stream handler (idempotent).
"""
from __future__ import annotations

import logging
import sys

from repro_torch.obs.audit import NULL_AUDIT, NullAudit, SelectorAudit
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                               MetricsRegistry)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer  # noqa: F401

__all__ = ["Telemetry", "Tracer", "NullTracer", "NULL_TRACER",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "SelectorAudit", "NullAudit", "NULL_AUDIT",
           "get_logger", "enable_verbose"]


class Telemetry:
    """One run's telemetry bundle: ``tracer`` + ``metrics`` + ``audit``.

    ``enabled=False`` (default) keeps the metrics registry live but
    swaps the tracer and audit for their null singletons; ``metrics``
    may be shared across components by passing one registry in.
    """

    def __init__(self, enabled: bool = False,
                 metrics: MetricsRegistry | None = None):
        self.enabled = bool(enabled)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = Tracer() if self.enabled else NULL_TRACER
        self.audit = SelectorAudit() if self.enabled else NULL_AUDIT

    def summary(self) -> dict:
        """The ``MinibatchResult.telemetry`` view: calibration report plus
        span/audit volume and the full metrics snapshot."""
        return dict(enabled=self.enabled,
                    n_span_events=len(self.tracer.events()),
                    n_audit_events=len(self.audit.events()),
                    calibration=self.audit.calibration(),
                    metrics=self.metrics.snapshot())

    def export(self, trace_out: str | None = None,
               jsonl_out: str | None = None) -> None:
        """Write the Chrome trace and/or the JSONL event export (audit
        events + calibration + final metrics snapshot)."""
        if trace_out:
            self.tracer.export(trace_out)
        if jsonl_out:
            self.audit.export_jsonl(
                jsonl_out,
                extra=[dict(event="metrics", **self.metrics.snapshot())])


# ---------------------------------------------------------------------------
# Namespaced logging (replaces print-based verbose output)
# ---------------------------------------------------------------------------

_VERBOSE_MARK = "_repro_torch_verbose_handler"


def get_logger(name: str = "repro_torch.train") -> logging.Logger:
    return logging.getLogger(name)


def enable_verbose(name: str = "repro_torch.train",
                   level: int = logging.INFO) -> logging.Logger:
    """Install a plain message-only stdout handler on ``name`` once
    (idempotent) — the ``verbose=True`` convenience.  stdout, not stderr,
    so driver output stays pipeable the way the old prints were."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not any(getattr(h, _VERBOSE_MARK, False) for h in logger.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        setattr(handler, _VERBOSE_MARK, True)
        logger.addHandler(handler)
    return logger
