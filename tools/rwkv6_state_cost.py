"""What the float64 state of the rwkv6_chunked CUDA kernel costs and buys.

Builds ``src/repro_torch/kernels/csrc/rwkv6_chunked.cu`` as the port ships
it (float64 state) and with ``-DRWKV6_STATE_T=float`` (float32 state), then
on the card, for each case, times both (CUDA events, L2 flushed, median of
``--reps`` calls, in turns: shipped, float32 state, float32 state, shipped)
and holds both against the plain version run in float64 at the reference's
tolerances (tests/test_kernels_rwkv6.py:41-42).  Cases: RWKV6-7B's prefill
shape (4, 64, 1024, 64) with random decays in bfloat16 and float32, and
(1, 64, 4096, 64) in float32 with w within 2e-9 of 1 (the state's largest
growth).  Prints one JSON line per case and the card's name and power
limit.  Needs one CUDA card and nvcc:

    PYTHONPATH=src python3 tools/rwkv6_state_cost.py
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rwkv6_chunked as rk

TOL = {torch.float32: dict(atol=5e-4, rtol=1e-3),
       torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
CASES = (((4, 64, 1024, 64), torch.bfloat16, "rand"),
         ((4, 64, 1024, 64), torch.float32, "rand"),
         ((1, 64, 4096, 64), torch.float32, "one"))


def inputs(gen, shape, dtype, decay):
    """r, k, v ~ N(0, 1) in ``dtype``; w = exp(-exp(rate)) float32 with the
    rate N(0, 1) clipped to the model's [-20, 0.405] ("rand") or -20
    ("one"); u ~ N(0, 1) float32."""
    r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    rate = (torch.randn(shape, generator=gen, device="cuda").clamp(-20, 0.405)
            if decay == "rand" else torch.full(shape, -20.0, device="cuda"))
    u = torch.randn(shape[1::2], generator=gen, device="cuda")
    return r, k, v, torch.exp(-torch.exp(rate)), u


def launcher(lib, args):
    """A call of ``lib``'s launch on ``args`` into a fresh output, as the
    wrapper ``rwkv6_chunked_kernel`` makes it."""
    r, k, v, w, u = args
    code = _build.cuda_dtype_code((r, k, v))

    def call():
        o = torch.empty_like(r)
        lib.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), o.data_ptr(), *r.shape, code,
                   _build.stream(r))
        return o
    return call


def median_ms(fn, flush, reps: int) -> float:
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def worst_ratio(got, want, dtype) -> float:
    """max |got - want| / (atol + rtol |want|); inf where got is not
    finite."""
    g = got.double()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    tol = TOL[dtype]
    return float(((g - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
                  ).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    libs = {"float64 state": _build.library("rwkv6_chunked"),
            "float32 state": _build.build_variant("rwkv6_chunked",
                                                  ("RWKV6_STATE_T=float",))}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(24)
    for shape, dtype, decay in CASES:
        a = inputs(gen, shape, dtype, decay)
        want = rk.plain(*(t.double() for t in a))
        calls = {n: launcher(lib, a) for n, lib in libs.items()}
        runs = {n: [] for n in libs}
        for n in ("float64 state", "float32 state", "float32 state",
                  "float64 state"):
            runs[n].append(median_ms(calls[n], flush, args.reps))
        torch.cuda.synchronize()
        print(json.dumps(dict(
            shape=list(shape), dtype=str(dtype).removeprefix("torch."),
            decay=decay,
            **{n: dict(ms=runs[n], worst_err_over_limit=worst_ratio(
                calls[n](), want, dtype)) for n in libs})), flush=True)


if __name__ == "__main__":
    main()
