#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path, full-batch GCN inference on the pubmed-sized
synthetic graph at the paper's full widths (500 features, hidden 16,
3 classes, 2 layers), through the two hand-written CUDA kernels, and
checks every result.  Run it from the root of a checkout with no
arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. build: every kernel source compiles with nvcc for sm_90a, in parallel;
   prints the build time and ptxas register/spill lines;
2. kernels: each kernel against its plain PyTorch version on the card,
   float32 and bfloat16, F in {3, 16, 500}, with and without y_in, on the
   main path's payloads (B = 16) and on synthetic ones with B in {8, 32,
   64}; tolerances are the reference's (tests/test_fused.py): float32
   atol = rtol = 1e-4, bfloat16 atol = 2e-1, rtol = 3e-1;
3. main path: prepare -> init_model -> forward with acc=False and
   acc=True; launch counts are reset just before and read just after, and
   each kernel must have launched twice per forward; the logits must be
   finite, of shape (n_pad, 3), and agree (float32 1e-4) with the same
   forward on the CPU (plain versions) and with an independent edge-list
   GCN on the CPU;
4. timing: median forward time (CUDA events), each kernel's time at the
   main path's shapes (F = 16 and 3) beside its plain version, one
   PyTorch library call computing the same function and its bound, a
   torch.profiler table and the device-busy share of a forward.

Float32 products run in full float32 (TF32 off for matmul and cuDNN).
The last two lines are the kernels JSON and the device JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-1, rtol=3e-1)
# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores, dense bfloat16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
L2_FLUSH_BYTES = 128 << 20   # > the 50 MB L2: a launch after it finds L2 cold

KERNELS = {
    "block_diag_spmm": dict(
        source="src/repro_torch/kernels/csrc/block_diag_spmm.cu",
        replaces="src/repro/kernels/block_diag_spmm.py:35"),
    "bell_spmm": dict(
        source="src/repro_torch/kernels/csrc/bell_spmm.cu",
        replaces="src/repro/kernels/bell_spmm.py:69"),
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max().item())


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, flush=None, inner: int = 10, reps: int = 15) -> float:
    """Median device time of one ``fn()`` in ms: ``inner`` calls captured in
    one CUDA graph (so host launch cost is not timed), replayed ``reps``
    times between CUDA events.  With ``flush``, every call is preceded by
    ``flush()`` and the flush's own time is subtracted."""
    def body():
        if flush is not None:
            flush()
        fn()

    def timed(f) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                f()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                f()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / inner)
        return statistics.median(times)

    t = timed(body)
    if flush is not None:
        t -= timed(flush)
    return t


def eager_ms(torch, fn, iters: int = 20) -> float:
    """Median of per-call CUDA-event times of ``fn()`` run eagerly (host
    launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    """Least time in ms for moving ``n_bytes`` and doing ``n_ops``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    log("build", f"{len(libs)} kernels in {dt:.2f} s ("
        + ", ".join(f"{n} nvcc {b.seconds:.2f} s" for n, b in libs.items())
        + ")")
    for name, b in libs.items():
        for line in b.ptxas:
            log("build", f"{name}: {line}")


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def synthetic_bell(torch, gen, B: int, dev, nbr: int = 40, K: int = 5):
    """A random blocked-ELL payload honouring the format's contract:
    n_valid[i] leading slots hold blocks, the rest are zero blocks that
    point at block column 0."""
    nbc = nbr + 3
    n_valid = torch.randint(0, K + 1, (nbr,), generator=gen, device=dev,
                            dtype=torch.int32)
    slot = torch.arange(K, device=dev)[None, :]
    valid = slot < n_valid[:, None]
    col_idx = torch.randint(0, nbc, (nbr, K), generator=gen, device=dev,
                            dtype=torch.int32) * valid
    blocks = torch.randn((nbr, K, B, B), generator=gen, device=dev)
    blocks = blocks * valid[:, :, None, None]
    return blocks, col_idx.to(torch.int32), n_valid, nbc * B


def phase_kernels(torch, dec) -> dict:
    """Each kernel against its plain version on ``dec``'s device; returns the
    largest float32 and bfloat16 errors per kernel."""
    from repro_torch.kernels import bell_spmm as bell_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(0)
    bd = dec.intra.formats["block_diag"]
    bell = dec.sub("inter").formats["bell"][0]
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in KERNELS}

    # the main path's payloads first, then synthetic ones of other sizes
    bd_cases = [(bd.block_size, bd.blocks)] + [
        (B, torch.randn((40, B, B), generator=gen, device=dev))
        for B in (8, 16, 32, 64) if B != bd.block_size]
    bell_cases = [(bell.block_size, (bell.blocks, bell.col_idx,
                                     bell.n_valid, bell.n_cols))] + [
        (B, synthetic_bell(torch, gen, B, dev))
        for B in (8, 16, 32, 64) if B != bell.block_size]
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for F in (3, 16, 500):
            for with_y in (False, True):
                for i, (B, blocks) in enumerate(bd_cases):
                    n = blocks.shape[0] * B
                    x = torch.randn((n, F), generator=gen, device=dev)
                    y_in = (torch.randn((n, F), generator=gen, device=dev)
                            .to(dtype) if with_y else None)
                    args = (blocks.to(dtype), x.to(dtype), y_in)
                    got = bd_mod.block_diag_spmm(*args)
                    want = bd_mod.plain(*args)
                    sync(torch, dev)
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                    e = max_err(got, want)
                    errs["block_diag_spmm"][name] = max(
                        errs["block_diag_spmm"][name], e)
                    if i == 0:
                        log("kernel", f"block_diag_spmm {name} F={F} "
                            f"y_in={with_y}: max|err| {e:.3g}")
                    n_cases += 1
                for i, (B, (blocks, col_idx, n_valid, n_cols)) in enumerate(
                        bell_cases):
                    x = torch.randn((n_cols, F), generator=gen,
                                    device=dev).to(dtype)
                    n_rows = blocks.shape[0] * B
                    y_in = (torch.randn((n_rows, F), generator=gen,
                                        device=dev).to(dtype)
                            if with_y else None)
                    got = bell_mod.bell_spmm(blocks.to(dtype), col_idx, x,
                                             y_in, n_valid=n_valid)
                    want = bell_mod.plain(blocks.to(dtype), col_idx, x, y_in)
                    sync(torch, dev)
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                    e = max_err(got, want)
                    errs["bell_spmm"][name] = max(errs["bell_spmm"][name], e)
                    if i == 0:
                        log("kernel", f"bell_spmm {name} F={F} "
                            f"y_in={with_y}: max|err| {e:.3g}")
                    n_cases += 1
    # every slot, without the count of real blocks (the TPU kernel's loop)
    x = torch.randn((bell.n_cols, 16), generator=gen, device=dev)
    got = bell_mod.bell_spmm(bell.blocks, bell.col_idx, x)
    want = bell_mod.plain(bell.blocks, bell.col_idx, x)
    sync(torch, dev)
    torch.testing.assert_close(got, want, **F32_TOL)
    errs["bell_spmm"]["float32"] = max(errs["bell_spmm"]["float32"],
                                       max_err(got, want))
    log("kernel", f"{n_cases + 1} cases within tolerance (main-path "
        f"payloads and B in 8, 16, 32, 64); largest errors {errs}")
    return errs


def bsr_of(torch, bell):
    """The blocked-ELL payload's real blocks as a torch BSR tensor (the
    library yardstick for bell_spmm), or None where PyTorch cannot build
    or multiply one on this card."""
    nbc = bell.n_cols // bell.block_size
    valid = (torch.arange(bell.max_blocks, device=bell.blocks.device)[None, :]
             < bell.n_valid[:, None])
    brow = torch.arange(bell.n_brow, device=valid.device)[:, None].expand_as(
        valid)[valid]
    bcol = bell.col_idx[valid].long()
    order = torch.argsort(brow * nbc + bcol)
    crow = torch.zeros(bell.n_brow + 1, dtype=torch.int64,
                       device=valid.device)
    crow[1:] = torch.cumsum(bell.n_valid.long(), 0)
    try:
        bsr = torch.sparse_bsr_tensor(crow, bcol[order],
                                      bell.blocks[valid][order],
                                      size=(bell.n_rows, bell.n_cols),
                                      check_invariants=True)
        bsr @ torch.zeros((bell.n_cols, 16), device=valid.device)
    except (RuntimeError, NotImplementedError) as exc:
        log("timing", f"no torch BSR product for bell_spmm on this card "
            f"({type(exc).__name__}: {exc}); library_ms is null")
        return None
    return bsr


def edge_list_gcn(torch, graph, params) -> "torch.Tensor":
    """Independent CPU reference: the GCN forward on the original edge
    list (self-loops, symmetric norm, index_add_), in original node order.

    ``add_self_loops`` duplicates the (v, v) edges a graph already has; the
    reference's block formats store such an edge once (both copies carry
    the same norm value), so the edge list keeps the first copy too."""
    import numpy as np
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.add_self_loops(graph)
    vals = graph_mod.gcn_norm_values(g.n, g.senders, g.receivers)
    _, first = np.unique(g.receivers.astype(np.int64) * g.n + g.senders,
                         return_index=True)
    vals = torch.from_numpy(vals[first])
    snd = torch.from_numpy(g.senders[first]).long()
    rcv = torch.from_numpy(g.receivers[first]).long()
    h = torch.from_numpy(graph.features)
    for i, layer in enumerate(params):
        hw = h @ layer["w"].cpu()
        y = torch.zeros((g.n, hw.shape[1])).index_add_(
            0, rcv, hw[snd] * vals[:, None])
        h = y + layer["b"].cpu()
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def phase_main(torch, graph, cfg, dec, counts: dict):
    """The main path on ``dec``'s device: init_model, then forward with
    acc=False and acc=True, with the launch counts set to 0 just before and
    read just after.  Checks the logits against the same forward on the
    CPU and against :func:`edge_list_gcn`.  Returns (plan, params, x,
    launches)."""
    from repro_torch.core import adaptgear, gnn
    dev = dec.device
    in_dim, n_classes = graph.features.shape[1], graph.n_classes
    plan, _ = gnn.select_plan(dec, cfg, [(in_dim, cfg.hidden),
                                         (cfg.hidden, n_classes)])
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            in_dim, n_classes, device=dev)
    feats = torch.from_numpy(graph.features)
    x = adaptgear.to_reordered(dec, feats.to(dev))
    for c in counts.values():
        c.reset()
    logits = {acc: gnn.forward(params, cfg, dec, x, plan, acc=acc)
              for acc in (False, True)}
    sync(torch, dev)
    launches = {k: c.value for k, c in counts.items()}
    log("main", f"plan {plan.layers}; launches over {len(logits)} forwards "
        f"{launches}")

    dec_cpu = dec.to("cpu")
    params_cpu = [{k: v.cpu() for k, v in p.items()} for p in params]
    x_cpu = adaptgear.to_reordered(dec_cpu, feats)
    edge_ref = edge_list_gcn(torch, graph, params)
    ids = [0, 1, graph.n // 2, graph.n - 1]
    for acc, y in logits.items():
        if tuple(y.shape) != (dec.n_pad, n_classes):
            raise RuntimeError(f"logits shape {tuple(y.shape)}")
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("non-finite logits")
        y_cpu = gnn.forward(params_cpu, cfg, dec_cpu, x_cpu, plan, acc=acc)
        torch.testing.assert_close(y.cpu(), y_cpu, **F32_TOL)
        y_orig = adaptgear.from_reordered(dec_cpu, y.cpu())
        torch.testing.assert_close(y_orig, edge_ref, **F32_TOL)
        log("main", f"acc={acc}: logits at ids {ids} = "
            f"{y_orig[ids].tolist()}; max|{dev.type} - cpu| "
            f"{max_err(y.cpu(), y_cpu):.3g}, max|{dev.type} - edge-list GCN| "
            f"{max_err(y_orig, edge_ref):.3g}")
    return plan, params, x, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from repro_torch.core import gnn
    from repro_torch.graphs import graph as graph_mod
    from repro_torch.kernels import bell_spmm as bell_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    counts = {"block_diag_spmm": bd_mod.launches,
              "bell_spmm": bell_mod.launches}

    # 1. build ---------------------------------------------------------------
    phase_build(torch)

    # prepare the pubmed-sized graph (Table-1 row, scale 1.0) -----------------
    graph = graph_mod.synth_dataset("pubmed", scale=1.0, seed=0)
    cfg = gnn.GNNConfig(model="gcn", hidden=16, n_layers=2, comm_size=16,
                        reorder="bfs", inter_buckets=1, selector="fixed",
                        fixed_kernels=("block_diag", "bell"), seed=0)
    t0 = time.perf_counter()
    dec = gnn.prepare(graph, cfg, device="cuda")
    torch.cuda.synchronize()
    bd = dec.intra.formats["block_diag"]
    bell, bell_t = dec.sub("inter").formats["bell"]
    log("prepare", f"{time.perf_counter() - t0:.2f} s; {graph.name} "
        f"n={graph.n} edges={graph.n_edges} features="
        f"{graph.features.shape[1]} classes={graph.n_classes} "
        f"n_pad={dec.n_pad}; block_diag {tuple(bd.blocks.shape)}, bell "
        f"{tuple(bell.blocks.shape)} ({int(bell.n_valid.sum())} real "
        f"blocks), bell_t {tuple(bell_t.blocks.shape)}")

    # 2. kernels against their plain versions --------------------------------
    errs = phase_kernels(torch, dec)

    # 3. main path -----------------------------------------------------------
    plan, params, x, launches = phase_main(torch, graph, cfg, dec, counts)
    n_fwd = 2
    for k, v in launches.items():
        if v != 2 * n_fwd:
            raise RuntimeError(f"{k} launched {v} times in {n_fwd} "
                               f"forwards, expected {2 * n_fwd}")

    # 4. timing --------------------------------------------------------------
    fwd_ms = {acc: eager_ms(torch, lambda acc=acc: gnn.forward(
        params, cfg, dec, x, plan, acc=acc)) for acc in (False, True)}
    log("timing", f"forward median (CUDA events, host launch included): "
        f"acc=False {fwd_ms[False]:.4f} ms, acc=True {fwd_ms[True]:.4f} ms")

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(1)
    nb, B = bd.blocks.shape[0], bd.block_size
    nv = int(bell.n_valid.sum())
    bsr = bsr_of(torch, bell)
    rows = {"block_diag_spmm": {}, "bell_spmm": {}}
    for F in (16, 3):
        h = torch.randn((dec.n_pad, F), generator=gen, device="cuda")
        xb = h.view(nb, B, F)
        if bsr is not None:
            torch.testing.assert_close(bsr @ h, bell_mod.plain(
                bell.blocks, bell.col_idx, h), **F32_TOL)
        torch.testing.assert_close(torch.bmm(bd.blocks, xb).view(-1, F),
                                   bd_mod.plain(bd.blocks, h), **F32_TOL)
        be = 4
        n_bytes = (nb * B * B + 2 * dec.n_pad * F) * be
        b_ms, b_by = bound(n_bytes, 2.0 * nb * B * B * F, "float32")
        rows["block_diag_spmm"][F] = dict(
            ms=graph_ms(torch, lambda: bd_mod.block_diag_spmm(bd.blocks, h),
                        flush),
            ms_warm_l2=graph_ms(torch, lambda: bd_mod.block_diag_spmm(
                bd.blocks, h)),
            plain_ms=graph_ms(torch, lambda: bd_mod.plain(bd.blocks, h),
                              flush),
            library_ms=graph_ms(torch, lambda: torch.bmm(bd.blocks, xb),
                                flush),
            library_call="torch.bmm(blocks, x.view(nb, B, F))",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bd.blocks.shape), [dec.n_pad, F]])
        Bb = bell.block_size
        n_bytes = (nv * (Bb * Bb * be + 4) + bell.n_brow * 4
                   + bell.n_cols * F * be + bell.n_rows * F * be)
        b_ms, b_by = bound(n_bytes, 2.0 * nv * Bb * Bb * F, "float32")
        rows["bell_spmm"][F] = dict(
            ms=graph_ms(torch, lambda: bell_mod.bell_spmm(
                bell.blocks, bell.col_idx, h, n_valid=bell.n_valid), flush),
            plain_ms=graph_ms(torch, lambda: bell_mod.plain(
                bell.blocks, bell.col_idx, h), flush),
            library_ms=(eager_ms(torch, lambda: bsr @ h)
                        if bsr is not None else None),
            library_call="torch.sparse_bsr_tensor(real blocks) @ x, eager",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bell.blocks.shape), [nv, "real blocks"],
                   [dec.n_pad, F]])
        for k in rows:
            r = rows[k][F]
            log("timing", f"{k} F={F}: {r['ms']:.4f} ms (L2 cold), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms "
                f"({r['library_call']}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    del scratch

    prof_iters = 5
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_iters):
            gnn.forward(params, cfg, dec, x, plan)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / prof_iters
    dev_rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_rows.append((us / prof_iters, e.count // prof_iters, e.key))
    dev_rows.sort(reverse=True)
    for us, cnt, key in dev_rows[:8]:
        log("profile", f"{us:9.1f} us/forward  x{cnt}  {key[:90]}")
    busy_us = sum(r[0] for r in dev_rows)
    if busy_us > 0:
        busy = dict(busy_us_per_forward=busy_us,
                    share_of_profiled_wall=busy_us / wall_us,
                    share_of_median_forward=busy_us / (fwd_ms[False] * 1e3))
        log("profile", f"device busy {busy_us:.1f} us per forward: "
            f"{100 * busy['share_of_median_forward']:.1f} % of the median "
            f"forward ({fwd_ms[False] * 1e3:.1f} us), "
            f"{100 * busy['share_of_profiled_wall']:.1f} % of the profiled "
            f"wall ({wall_us:.1f} us)")
    else:
        busy = None
        log("profile", "the profiler recorded no device time: device-busy "
            "share not measured")

    out = []
    for name, meta in KERNELS.items():
        r16 = rows[name][16]
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            launches_per_forward=launches[name] // n_fwd,
            max_abs_err=errs[name]["float32"],
            max_abs_err_bf16=errs[name]["bfloat16"],
            ms=r16["ms"], plain_ms=r16["plain_ms"],
            bound_ms=r16["bound_ms"], bound_by=r16["bound_by"],
            library_ms=r16["library_ms"],
            dtype="float32", width=16,
            by_width={str(F): rows[name][F] for F in (16, 3)}))
    log("done", f"{time.perf_counter() - t_start:.1f} s; forward_ms "
        f"{ {str(k): v for k, v in fwd_ms.items()} }; busy {busy}")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
