"""Selector audit log: every committed kernel plan, with receipts.

Counterpart of ``repro/obs/audit.py`` (pure Python, the same numbers).

AdaptGear's core claim is that adaptive per-subgraph kernel selection
balances sparsity benefit against kernel efficiency.  The audit log
records the *decision data*: every plan the PlanCache mints carries its per
(layer, tier) kernel choice and the cost model's modeled seconds for that
choice; every probe-on-Nth-miss measurement lands as a
(kernel, modeled, measured) pair; quarantine and degradation events are
stamped as they happen; and the training loop reports the observed
wall-time of each step attributed to the plan that ran it.

From that stream, :meth:`SelectorAudit.calibration` derives the cost
model's calibration report: per-kernel and per-plan predicted-vs-measured
relative error.  ``export_jsonl`` writes the raw
event stream (one JSON object per line) for offline analysis.

Determinism non-interference: the audit is append-only and is never read
by selection, the cache, or the pipeline — recording cannot alter cache
decisions, plan choices, or batch order.  :class:`NullAudit` is the
disabled counterpart (every method a no-op), so call sites stay
unconditional.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["SelectorAudit", "NullAudit", "NULL_AUDIT"]

# per-plan observed-step sample cap: enough for a stable median, bounded
# on long runs
_MAX_STEP_SAMPLES = 4096


def _layers_key(layers) -> tuple:
    return tuple(tuple(layer) for layer in layers)


def _median(xs: list) -> float:
    ys = sorted(xs)
    n = len(ys)
    if not n:
        return 0.0
    mid = n // 2
    return float(ys[mid]) if n % 2 else float((ys[mid - 1] + ys[mid]) / 2.0)


class SelectorAudit:
    """Append-only, thread-safe event log of selection decisions."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._events: list[dict] = []
        # plan layers -> observed step wall seconds
        self._step_s: dict[tuple, list] = {}
        # plan layers -> total modeled seconds at mint time
        self._modeled_total: dict[tuple, float] = {}

    def _append(self, event: str, **fields) -> None:
        rec = dict(event=event, t=time.perf_counter() - self._epoch)
        rec.update(fields)
        with self._lock:
            self._events.append(rec)

    # -- recording ----------------------------------------------------------

    def plan(self, *, sig, layers, tiers, modeled_s, source: str,
             bell_slack=None) -> None:
        """One committed (minted) plan: per-(layer, tier) kernel choices
        and the modeled seconds of each choice.  ``source`` says how it
        was selected: ``cost_model``, ``probe`` (probe-pinned winner), or
        ``fixed``."""
        layers = _layers_key(layers)
        total = float(sum(sum(row) for row in modeled_s)) if modeled_s else 0.0
        with self._lock:
            self._modeled_total.setdefault(layers, total)
        self._append("plan", sig=str(sig), tiers=list(tiers),
                     layers=[list(layer) for layer in layers],
                     modeled_s=[[float(c) for c in row]
                                for row in (modeled_s or [])],
                     modeled_total_s=total, source=source,
                     bell_slack=bell_slack)

    def probe(self, *, tier, kernel, modeled_s, measured_s,
              in_dim=None, agg_dim=None) -> None:
        """One wall-clock probe measurement of a candidate kernel."""
        self._append("probe", tier=tier, kernel=kernel,
                     modeled_s=float(modeled_s),
                     measured_s=float(measured_s),
                     in_dim=in_dim, agg_dim=agg_dim)

    def quarantine(self, *, sig, kernels, reason: str = "") -> None:
        self._append("quarantine", sig=str(sig),
                     kernels=sorted(str(k) for k in kernels), reason=reason)

    def degrade(self, *, from_layers, to_layers, error: str = "") -> None:
        """A broken plan was replaced by a re-selected fallback."""
        self._append("degrade",
                     from_layers=[list(l) for l in from_layers],
                     to_layers=[list(l) for l in to_layers], error=error)

    def observe_step(self, layers, seconds: float) -> None:
        """Observed device-step wall time attributed to the plan that ran
        it (the measured side of the per-plan calibration)."""
        key = _layers_key(layers)
        with self._lock:
            samples = self._step_s.setdefault(key, [])
            if len(samples) < _MAX_STEP_SAMPLES:
                samples.append(float(seconds))

    # -- reporting ----------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def calibration(self) -> dict:
        """Cost-model calibration report.

        ``kernels``: per probed kernel, the median relative error of the
        modeled cost against the probe's wall-clock measurement —
        |measured - modeled| / modeled (the same quantity PlanCache's
        adaptive probe widening keys on, now visible per kernel).

        ``plans``: per committed plan, the modeled whole-plan seconds at
        mint time against the median observed step wall time (the step
        includes the dense epilogue + optimizer the model doesn't price,
        so treat plan-level error as a trend signal, not an absolute).
        """
        with self._lock:
            events = list(self._events)
            step_s = {k: list(v) for k, v in self._step_s.items()}
            modeled = dict(self._modeled_total)
        by_kernel: dict[str, list] = {}
        for e in events:
            if e["event"] == "probe" and e["modeled_s"] > 0:
                by_kernel.setdefault(e["kernel"], []).append(
                    (e["modeled_s"], e["measured_s"]))
        kernels = {
            k: dict(n=len(v),
                    modeled_s=_median([m for m, _ in v]),
                    measured_s=_median([s for _, s in v]),
                    rel_err=_median([abs(s - m) / m for m, s in v]))
            for k, v in sorted(by_kernel.items())}
        plans = []
        for key, samples in step_s.items():
            mod = modeled.get(key)
            obs_s = _median(samples)
            entry = dict(layers=[list(l) for l in key], n_steps=len(samples),
                         observed_step_s=obs_s, modeled_s=mod)
            if mod:
                entry["rel_err"] = abs(obs_s - mod) / mod
            plans.append(entry)
        return dict(kernels=kernels, plans=plans)

    def export_jsonl(self, path: str, extra: list | None = None) -> str:
        """One JSON object per line: the event stream, then the
        calibration summary, then any ``extra`` records (the Telemetry
        facade appends the final metrics snapshot)."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            for e in self.events():
                f.write(json.dumps(e, default=str) + "\n")
            f.write(json.dumps(dict(event="calibration",
                                    **self.calibration()),
                               default=str) + "\n")
            for rec in extra or ():
                f.write(json.dumps(rec, default=str) + "\n")
        return path


class NullAudit:
    """Disabled audit: recording is a no-op, reports are empty."""

    enabled = False

    def plan(self, **kw) -> None:
        return None

    def probe(self, **kw) -> None:
        return None

    def quarantine(self, **kw) -> None:
        return None

    def degrade(self, **kw) -> None:
        return None

    def observe_step(self, layers, seconds: float) -> None:
        return None

    def events(self) -> list:
        return []

    def calibration(self) -> dict:
        return dict(kernels={}, plans=[])

    def export_jsonl(self, path: str, extra: list | None = None) -> str:
        raise RuntimeError("cannot export a disabled (null) audit; "
                           "enable telemetry to record selector decisions")


NULL_AUDIT = NullAudit()
