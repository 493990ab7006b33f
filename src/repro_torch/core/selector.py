"""Adaptive kernel selector (paper §3.3).

Counterpart of ``repro/core/selector.py``.  Both modes enumerate the
registry's candidates per subgraph (the intra tier and every inter
density bucket):

* ``feedback`` (the paper's, and ``GNNConfig``'s default):
  :class:`AdaptiveSelector` times every candidate on the real decomposed
  graph during warm-up and commits the fastest.  A full-batch run reuses
  one graph for hundreds of steps, so the probe's cost amortizes.  On
  CUDA each probe is timed between CUDA events; a first call outside the
  timing absorbs the kernels' first-launch build, as the reference's jit
  compile is kept out of its timing.  No probe sits inside a ``try``: a
  kernel that fails to build or launch fails the selection.
* ``cost_model``: an analytic two-term roofline (operations over peak,
  bytes over bandwidth) per candidate, from each spec's registered
  ``cost``, under a :class:`HwModel`.

:func:`default_hw` picks the model from the device: ``CPU_HW`` (the
reference's CPU constants) on the CPU, ``H100_HW`` on CUDA.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.decompose import Decomposed, Subgraph
from repro_torch.core.epilogue import EpilogueSpec, epilogue_cost
from repro_torch.kernels.registry import REGISTRY, _bytes_el


@dataclass(frozen=True)
class HwModel:
    """Per-device constants of the analytic cost model.  The defaults are
    the reference's (a TPU v5e), so both packages price alike under
    ``HwModel()``."""
    name: str = "tpu_v5e"
    peak_flops: float = 197e12      # FLOP/s
    hbm_bw: float = 819e9           # bytes/s
    launch_overhead_s: float = 2e-6
    gather_eff: float = 0.30        # share of streaming bandwidth a gather gets
    scatter_eff: float = 0.15       # scatter / segment-sum read-modify-write
    mxu_dim: int = 128              # matrix-unit width; 0: no tile de-rate

    def mxu_eff(self, b: int) -> float:
        """Matrix-unit utilization of (b, b) tiles: b / 128 on the TPU's
        128-wide array; 1 where the kernels use no matrix unit."""
        return min(b / self.mxu_dim, 1.0) if self.mxu_dim else 1.0


CPU_HW = HwModel(name="cpu_interpret", peak_flops=5e10, hbm_bw=2e10,
                 launch_overhead_s=5e-5)

# NVIDIA H100 SXM: the float32 rate outside the tensor cores and the HBM3
# rate (the bounds in PERF.md).  The port's kernels use no tensor cores,
# so no tile de-rate.  The three de-rates are first guesses for SM90, to
# be refit from the probes' times.
H100_LAUNCH_OVERHEAD_S = 10e-6   # an eager launch through wrapper and ctypes
H100_GATHER_EFF = 0.5
H100_SCATTER_EFF = 0.25
H100_HW = HwModel(name="h100_sxm_f32", peak_flops=67e12, hbm_bw=3.35e12,
                  launch_overhead_s=H100_LAUNCH_OVERHEAD_S,
                  gather_eff=H100_GATHER_EFF, scatter_eff=H100_SCATTER_EFF,
                  mxu_dim=0)


def default_hw(device: str | torch.device) -> HwModel:
    """The cost model of ``device``: ``H100_HW`` on CUDA, else ``CPU_HW``."""
    return H100_HW if torch.device(device).type == "cuda" else CPU_HW


def dense_transform_cost(n: int, fin: int, fout: int, dtype=np.float32,
                         hw: HwModel = HwModel()) -> float:
    """Roofline seconds of the dense transform H = X @ W that unfused
    candidates need before aggregation (fused kernels fold it in)."""
    be = _bytes_el(dtype)
    flops = 2.0 * n * fin * fout
    bytes_ = (n * fin + n * fout + fin * fout) * be
    return max(flops / hw.peak_flops, bytes_ / hw.hbm_bw) + hw.launch_overhead_s


def candidate_cost(sub: Subgraph, kernel: str, feat_dim: int,
                   dtype=np.float32, hw: HwModel = HwModel(),
                   in_dim: int | None = None,
                   transform_share: float = 0.0) -> float:
    """Modeled seconds of one (subgraph, kernel) candidate.  Fused kernels
    price the ``(in_dim, feat_dim)`` pair; unfused ones aggregate at
    ``feat_dim`` and carry ``transform_share``, their slice of the shared
    H = X @ W."""
    spec = REGISTRY.get(kernel)
    if spec.fused:
        if in_dim is None:
            raise ValueError(
                f"fused kernel {kernel!r} needs in_dim to be costed")
        return spec.cost(sub, (in_dim, feat_dim), dtype, hw)
    return spec.cost(sub, feat_dim, dtype, hw) + transform_share


def select_for_subgraph(sub: Subgraph, feat_dim: int, dtype=np.float32,
                        hw: HwModel = HwModel(), in_dim: int | None = None,
                        transform_share: float = 0.0,
                        exclude: frozenset = frozenset()) -> str:
    """The modeled-cheapest kernel of one subgraph (first on ties), among
    the candidates ``exclude`` does not name (the PlanCache's quarantine
    set)."""
    specs = [s for s in REGISTRY.candidates_for(
                 sub, include_fused=in_dim is not None)
             if s.name not in exclude]
    if not specs:
        raise ValueError(f"no kernel candidates for subgraph {sub.name!r}"
                         + (f" outside exclusion set {sorted(exclude)}"
                            if exclude else ""))
    return min(specs, key=lambda s: candidate_cost(
        sub, s.name, feat_dim, dtype, hw, in_dim, transform_share)).name


def _transform_share(dec: Decomposed, feat_dim: int, dtype, hw,
                     in_dim: int | None,
                     epilogue: EpilogueSpec | None = None) -> float:
    """Each subgraph's slice of the shared dense transform: its modeled
    cost over the subgraph count (0 without a transform, or when the
    epilogue computes it anyway)."""
    if in_dim is None or (epilogue is not None and epilogue.free_transform):
        return 0.0
    return (dense_transform_cost(dec.n_pad, in_dim, feat_dim, dtype, hw)
            / max(len(dec.subgraphs), 1))


def select_by_cost_model(dec: Decomposed, feat_dim: int, dtype=np.float32,
                         hw: HwModel = HwModel(), in_dim: int | None = None,
                         epilogue: EpilogueSpec | None = None,
                         exclude: frozenset = frozenset()
                         ) -> tuple[str, ...]:
    """One KernelPlan layer: the modeled-cheapest kernel per subgraph.
    With ``in_dim`` set, fused candidates compete and each unfused one is
    charged its share of the shared transform; ``exclude`` strikes kernel
    names from every subgraph's candidates."""
    share = _transform_share(dec, feat_dim, dtype, hw, in_dim, epilogue)
    return tuple(select_for_subgraph(s, feat_dim, dtype, hw, in_dim, share,
                                     exclude=exclude)
                 for s in dec.subgraphs)


def plan_layer_cost(dec: Decomposed, feat_dim: int, dtype=np.float32,
                    hw: HwModel = HwModel(), in_dim: int | None = None,
                    epilogue: EpilogueSpec | None = None) -> float:
    """Modeled seconds of one layer under the cost-argmin choice, the
    epilogue's dense terms included."""
    share = _transform_share(dec, feat_dim, dtype, hw, in_dim, epilogue)
    total = epilogue_cost(epilogue, dec.n_pad, in_dim, feat_dim, dtype, hw)
    for sub in dec.subgraphs:
        specs = REGISTRY.candidates_for(sub, include_fused=in_dim is not None)
        total += min(candidate_cost(sub, s.name, feat_dim, dtype, hw,
                                    in_dim, share) for s in specs)
    return total


def _times(fn, iters: int, device: torch.device) -> list[float]:
    """Seconds of ``iters`` calls of ``fn`` after one untimed call (which
    absorbs a kernel's first-launch build): between CUDA events on a CUDA
    device, by the host clock elsewhere."""
    fn()
    out = []
    for _ in range(iters):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
    return out


def plan_modeled_costs(dec: Decomposed, layers, pairs, dtype=np.float32,
                       hw: HwModel | None = None,
                       epilogues=None) -> list[list[float]]:
    """Modeled seconds of each chosen kernel of a committed plan:
    ``layers`` are its per-layer kernel-name tuples (aligned with
    ``dec.subgraphs``), ``pairs`` the ``(in_dim, agg_dim)`` of each layer.
    One row per layer, unfused kernels with their transform share as in
    selection (the selector audit's modeled side).  ``hw`` defaults to
    ``dec``'s device's model."""
    hw = hw or default_hw(dec.device)
    pairs = list(pairs)
    epilogues = epilogues or [None] * len(pairs)
    out = []
    for names, (fin, fout), ep in zip(layers, pairs, epilogues):
        share = _transform_share(dec, fout, dtype, hw, fin, ep)
        out.append([candidate_cost(sub, name, fout, dtype, hw, fin, share)
                    for sub, name in zip(dec.subgraphs, names)])
    return out


def _mean_time(fn, iters: int, device: torch.device) -> float:
    """Mean seconds of one call of ``fn`` over ``iters`` calls after one
    untimed call (a kernel's first-launch build): on a CUDA device all
    ``iters`` calls sit between one pair of CUDA events, so an eager
    call's launch gap between two events is not what is timed (ROADMAP
    section 3 fault 2); elsewhere the host clock."""
    fn()
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) * 1e-3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def _time_candidate(sub: Subgraph, spec, fin: int | None, fout: int,
                    dtype, iters: int, dev: torch.device) -> float:
    """Seconds of one call of a candidate on ones-filled operands of the
    tier's width on ``dev``, where its payloads are (:func:`_mean_time`):
    the unit :func:`probe_topk` and the PlanCache's Nth-miss probe
    measure."""
    from repro_torch.core import adaptgear  # local: import cycle
    tdt = _torch_dtype(dtype)
    with torch.no_grad():
        if spec.fused:
            x_in = torch.ones((sub.n_rows, fin), dtype=tdt, device=dev)
            w = torch.ones((fin, fout), dtype=tdt, device=dev)
            fn = (lambda: adaptgear.aggregate_sub_fused(sub, x_in, w,
                                                        spec.name))
        else:
            x = torch.ones((sub.n_rows, fout), dtype=tdt, device=dev)
            fn = lambda: adaptgear.aggregate_sub(sub, x, spec.name)  # noqa: E731
        return _mean_time(fn, iters, dev)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def probe_topk(dec: Decomposed, pairs, dtype=np.float32,
               hw: HwModel | None = None, k: int = 2,
               iters: int = 2, time_dec: Decomposed | None = None,
               epilogues=None, k_max: int | None = None,
               margin: float | None = None,
               time_budget_s: float | None = None,
               errs: list | None = None,
               timings: dict | None = None) -> list[tuple[str, ...]]:
    """Times only the ``k`` modeled-cheapest candidates per (layer,
    subgraph) and pins the measured fastest: the PlanCache's amortized
    feedback on every Nth miss.  Unfused candidates carry the modeled
    transform share; fused ones are timed whole.  ``pairs`` are the
    ``(in_dim, agg_dim)`` per layer, ``epilogues`` the aligned
    EpilogueSpecs.  Returns one kernel-name tuple per pair.

    With ``margin`` (the model's observed relative error) the frontier
    widens to every candidate within ``(1 + margin)`` of the modeled best,
    up to ``k_max``; ``time_budget_s`` caps the probe's wall time, after
    which untimed candidates are skipped.  ``errs`` collects
    ``(modeled_s, measured_s)`` per timed candidate, ``timings`` the same
    keyed by ``(sub_name, kernel, in_dim, agg_dim)``.  ``time_dec``
    supplies the payloads to time (the budget-padded twin, on the device
    that trains) while ``dec`` drives the ranking.  ``hw`` defaults to
    ``time_dec``'s (else ``dec``'s) device's model."""
    dev = (time_dec or dec).device
    hw = hw or default_hw(dev)
    timed: dict[tuple, float] = {}
    layers = []
    time_subs = (time_dec or dec).subgraphs
    pairs = list(pairs)
    epilogues = epilogues or [None] * len(pairs)
    t_start = time.perf_counter()

    def budget_left() -> bool:
        return (time_budget_s is None
                or time.perf_counter() - t_start < time_budget_s)

    for (fin, fout), ep in zip(pairs, epilogues):
        share = _transform_share(dec, fout, dtype, hw, fin, ep)
        choice = []
        for sub, tsub in zip(dec.subgraphs, time_subs):
            specs = REGISTRY.candidates_for(sub,
                                            include_fused=fin is not None)
            if not specs:
                raise ValueError(
                    f"no kernel candidates for subgraph {sub.name!r}")
            modeled = {s.name: candidate_cost(sub, s.name, fout, dtype, hw,
                                              fin, share) for s in specs}
            ranked = sorted(specs, key=lambda s: modeled[s.name])
            cands = ranked[:max(k, 1)]
            if margin is not None and len(ranked) > len(cands):
                lim = modeled[ranked[0].name] * (1.0 + max(margin, 0.0))
                cands += [s for s in ranked[len(cands):max(k_max or k, k)]
                          if modeled[s.name] <= lim]
            if len(cands) < 2:
                choice.append(cands[0].name)
                continue
            best_name, best_t = None, None
            for spec in cands:
                key = (sub.name, spec.name, fin or 0, fout)
                own = modeled[spec.name] - (0.0 if spec.fused else share)
                if key not in timed:
                    if not budget_left():
                        continue        # budget spent: modeled ranking holds
                    timed[key] = _time_candidate(tsub, spec, fin, fout,
                                                 dtype, iters, dev)
                    if errs is not None:
                        errs.append((own, timed[key]))
                    if timings is not None:
                        timings[key] = (own, timed[key])
                t = timed[key] + (0.0 if spec.fused else share)
                if best_t is None or t < best_t:
                    best_name, best_t = spec.name, t
            choice.append(best_name or cands[0].name)
        layers.append(tuple(choice))
    return layers


@dataclass
class ProbeResult:
    times: dict            # (subgraph name, kernel) -> median seconds
    choice: tuple          # kernel name per subgraph


class AdaptiveSelector:
    """Feedback-driven selector (paper §3.3).  ``observe()`` takes
    per-candidate times, ``choice()`` commits to the fastest per subgraph,
    and ``probe()`` measures every candidate at once.

    Observations are keyed by (subgraph, kernel, width) with the width the
    ``(in_dim, agg_dim)`` pair (in_dim 0 without a transform): two layers
    of one output width but different input widths may want different
    kernels, so their times never pool."""

    def __init__(self, dec: Decomposed, warmup_iters: int = 3,
                 include_fused: bool = False):
        self.dec = dec
        self.warmup_iters = warmup_iters
        # fused candidates need the transform operand at probe time
        self.include_fused = include_fused
        self._times: dict[tuple[str, str, tuple], list[float]] = {}
        self._committed: dict[tuple, tuple] = {}

    def _cands(self, sub: Subgraph):
        return REGISTRY.candidates_for(sub, include_fused=self.include_fused)

    @staticmethod
    def _wkey(width) -> tuple:
        """A width (int or (in_dim, agg_dim)) as a key."""
        if isinstance(width, tuple):
            return (width[0] or 0, width[1])
        return (0, width or 0)

    def observe(self, sub_name: str, kernel: str, seconds: float,
                width=0) -> None:
        key = (sub_name, kernel, self._wkey(width))
        self._times.setdefault(key, []).append(seconds)

    def _widths(self) -> set:
        return {w for (_, _, w) in self._times}

    def _need(self, width) -> list[tuple[str, str, tuple]]:
        wk = self._wkey(width)
        return [(s.name, spec.name, wk)
                for s in self.dec.subgraphs for spec in self._cands(s)]

    def ready(self, width=0) -> bool:
        width = self._nearest_width(width)
        return all(len(self._times.get(key, [])) >= self.warmup_iters
                   for key in self._need(width))

    def _nearest_width(self, width) -> tuple:
        ws = self._widths()
        wk = self._wkey(width)
        if not ws:
            return wk
        return min(ws, key=lambda w: (abs(w[1] - wk[1]), abs(w[0] - wk[0])))

    def choice(self, feat_dim=None) -> tuple:
        """The committed kernels of the width nearest ``feat_dim``; before
        enough observations, the cost model's choice."""
        w = self._nearest_width(feat_dim or 0)
        if w in self._committed:
            return self._committed[w]
        if self._times and self.ready(w):
            med = {k: float(np.median(v)) for k, v in self._times.items()}
            self._committed[w] = tuple(
                min(self._cands(s),
                    key=lambda spec: med[(s.name, spec.name, w)]).name
                for s in self.dec.subgraphs)
            return self._committed[w]
        if feat_dim is None:
            raise ValueError("need feat_dim for the cost-model fallback")
        fin, fout = self._wkey(feat_dim)
        return select_by_cost_model(self.dec, fout,
                                    hw=default_hw(self.dec.device),
                                    in_dim=fin or None)

    def probe(self, x: torch.Tensor, iters: int = 3,
              transform: tuple | None = None,
              free_transform: bool = False) -> ProbeResult:
        """Time every candidate on the real decomposed input.

        ``x`` is the aggregated-width operand of the unfused kernels.
        ``transform`` is the optional ``(x_in, w)`` pair of a
        transform-first layer: fused candidates are timed on
        A @ (x_in W), and each unfused one is charged its share of the
        measured H = x_in @ w (nothing with ``free_transform``)."""
        from repro_torch.core import adaptgear  # local: import cycle
        dev = x.device
        n_sub = max(len(self.dec.subgraphs), 1)
        share = 0.0
        with torch.no_grad():
            if transform is not None:
                x_in, w_mat = transform
                width = (x_in.shape[-1], x.shape[-1])
                if not free_transform:
                    share = float(np.median(_times(
                        lambda: torch.matmul(x_in, w_mat), iters, dev))) / n_sub
            else:
                width = x.shape[-1]
            for sub in self.dec.subgraphs:
                for spec in self._cands(sub):
                    if spec.fused:
                        if transform is None:
                            continue
                        fn = (lambda s=sub, k=spec.name:
                              adaptgear.aggregate_sub_fused(s, x_in, w_mat, k))
                        extra = 0.0
                    else:
                        fn = (lambda s=sub, k=spec.name:
                              adaptgear.aggregate_sub(s, x, k))
                        extra = share
                    for t in _times(fn, iters, dev):
                        self.observe(sub.name, spec.name, t + extra, width)
        wk = self._wkey(width)
        med = {(s, k): float(np.median(v))
               for (s, k, w), v in self._times.items() if w == wk}
        return ProbeResult(times=med, choice=self.choice(width))
