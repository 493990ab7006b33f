#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's two paths on the pubmed-sized synthetic graph at the
paper's full widths (500 features, hidden 16, 3 classes, 2 layers): GCN
inference (``forward``) and full-batch GCN training (``train``) with the
paper's default plan ``("block_diag", "bell")`` and its fused twin
``("block_diag_fused", "bell_fused")``, through the five hand-written CUDA
kernels, and checks every result.  Run it from the root of a checkout with
no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. build: every kernel source compiles with nvcc for sm_90a, in parallel;
   prints the build time and ptxas register/spill lines;
2. kernels: each kernel against its plain PyTorch version on the card,
   float32 and bfloat16, with and without y_in, on the main path's
   payloads (B = 16) and on synthetic ones with B in {8, 32, 64}:
   block_diag_spmm and bell_spmm at F in {3, 16, 500}; the transposed read
   of block_diag_spmm, block_diag_spmm_fused (both reads), bell_spmm_fused
   and bell_spmm_dw (over the transpose payload, and over the diagonal
   blocks with K = 1) at (Fi, Fo) in {(500, 16), (16, 3), (3, 16)};
   tolerances are the reference's (tests/test_fused.py): float32
   atol = rtol = 1e-4, bfloat16 atol = 2e-1, rtol = 3e-1; dW (float32 on
   both sides, from unit-scale cotangents) within 1e-5 of max|dW|;
3. forward: prepare -> init_model -> forward with acc=False and acc=True;
   launch counts are reset just before and read just after, and each
   forward kernel must have launched twice per forward; the logits must be
   finite, of shape (n_pad, 3), and agree (float32 1e-4) with the same
   forward on the CPU (plain versions) and with an independent edge-list
   GCN on the CPU;
4. gradients: one loss.backward per plan on the card against the same on
   the CPU, from the same parameters, every gradient within float32 1e-4;
5. training (the main path): gnn.train for TRAIN_STEPS steps per plan
   from one parameter set, launch counts reset just before and read just
   after; the counts must equal TRAIN_STEPS times the per-step counts plus
   one forward's; each loss curve must fall and agree (atol 5e-3,
   rtol 1e-2, the reference's own for this comparison in
   tests/test_fused.py) with the same training on the CPU, with an
   independent edge-list GCN trained with autograd and the same Adam, and
   with the other plan's curve;
6. timing: median forward and training-step times (CUDA events, host
   launch included), each kernel's time at the main path's shapes beside
   its plain version, one PyTorch library call (or composite) computing
   the same function and its bound, and torch.profiler tables with the
   device-busy share of a forward and of a training step per plan.

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
# bell_spmm_dw: max|got - want| / max|want|.  dW is float32 for either input
# dtype and both sides sum the same operand values in float32, so only the
# order of the sums differs; a dropped block row or split moves dW by far
# more.  At unit-scale cotangents |dW| reaches 1e4 on the pubmed payload,
# where an absolute 1e-4 would ask for more than float32 holds.
DW_REL_TOL = 1e-5
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
    "block_diag_spmm_fused": dict(      # bell_spmm_fused's kernel, K = 1
        source="src/repro_torch/kernels/csrc/bell_spmm_fused.cu",
        replaces="src/repro/kernels/block_diag_spmm_fused.py:54"),
    "bell_spmm_fused": dict(
        source="src/repro_torch/kernels/csrc/bell_spmm_fused.cu",
        replaces="src/repro/kernels/bell_spmm_fused.py:71"),
    "bell_spmm_dw": dict(
        source="src/repro_torch/kernels/csrc/bell_spmm_dw.cu",
        replaces="src/repro/kernels/bell_spmm_fused.py:145"),
}
FORWARD_KERNELS = ("block_diag_spmm", "bell_spmm")

TRAIN_STEPS = 20
CURVE_TOL = dict(atol=5e-3, rtol=1e-2)    # tests/test_fused.py:136
PLANS = {"unfused": ("block_diag", "bell"),
         "fused": ("block_diag_fused", "bell_fused")}
# kernel launches per training step and per forward of each plan (2
# layers).  Unfused: per layer one launch of each forward kernel, and one
# more in the backward (layer 1's too: dW = X^T dH needs dH).  Fused: per
# layer one launch of each fused kernel and two dW launches; the dX pass
# over the transpose runs for layer 2 only (layer 1's input is the raw
# features, which need no gradient).
PER_STEP = {"unfused": {"block_diag_spmm": 4, "bell_spmm": 4},
            "fused": {"block_diag_spmm_fused": 3, "bell_spmm_fused": 3,
                      "bell_spmm_dw": 4}}
PER_FORWARD = {"unfused": {"block_diag_spmm": 2, "bell_spmm": 2},
               "fused": {"block_diag_spmm_fused": 2, "bell_spmm_fused": 2}}
# (Fi, Fo) of the main path's fused kernels: layer 1, layer 2, and layer
# 2's dX pass over the transpose with W^T
WIDTHS = ((500, 16), (16, 3), (3, 16))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max().item())


def dw_rel_err(got, want, what: str) -> float:
    """max|got - want| / max|want| of a dW; raises above DW_REL_TOL."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{what}: {got.dtype} {tuple(got.shape)}, "
                           f"expected {want.dtype} {tuple(want.shape)}")
    rel = max_err(got, want) / float(want.abs().max())
    if not rel <= DW_REL_TOL:
        raise RuntimeError(f"{what}: max|err| / max|dW| = {rel:.3g} "
                           f"> {DW_REL_TOL}")
    return rel


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


def edge_list(torch, graph):
    """The GCN's normalized edge list in original node order: (senders,
    receivers, values) with self-loops and the symmetric norm.

    ``add_self_loops`` duplicates the (v, v) edges a graph already has; the
    reference's block formats store such an edge once (both copies carry
    the same norm value), so the edge list keeps the first copy too."""
    import numpy as np
    from repro_torch.graphs import graph as graph_mod
    g = graph_mod.add_self_loops(graph)
    vals = graph_mod.gcn_norm_values(g.n, g.senders, g.receivers)
    _, first = np.unique(g.receivers.astype(np.int64) * g.n + g.senders,
                         return_index=True)
    return (torch.from_numpy(g.senders[first]).long(),
            torch.from_numpy(g.receivers[first]).long(),
            torch.from_numpy(vals[first]))


def edge_list_forward(torch, feats, edges, params):
    """GCN forward over ``edge_list`` output with ``index_add_``."""
    snd, rcv, vals = edges
    h = feats
    for i, layer in enumerate(params):
        hw = h @ layer["w"]
        y = torch.zeros((feats.shape[0], hw.shape[1])).index_add_(
            0, rcv, hw[snd] * vals[:, None])
        h = y + layer["b"]
        if i != len(params) - 1:
            h = torch.relu(h)
    return h


def edge_list_gcn(torch, graph, params) -> "torch.Tensor":
    """Independent CPU reference: the GCN forward on the original edge
    list (self-loops, symmetric norm, index_add_), in original node order."""
    return edge_list_forward(
        torch, torch.from_numpy(graph.features), edge_list(torch, graph),
        [{k: v.cpu() for k, v in p.items()} for p in params])


def edge_list_train(torch, graph, params, steps: int, lr: float) -> list:
    """Independent CPU reference for training: the edge-list GCN, the mean
    negative log-likelihood over every node, torch autograd, and Adam as
    the reference writes it (repro/core/gnn.py _adam_update) transcribed
    here.  Returns the loss of each step."""
    edges = edge_list(torch, graph)
    feats = torch.from_numpy(graph.features)
    labels = torch.from_numpy(graph.labels).long()
    p = [{k: v.detach().cpu().clone() for k, v in q.items()} for q in params]
    m = [{k: torch.zeros_like(v) for k, v in q.items()} for q in p]
    v2 = [{k: torch.zeros_like(v) for k, v in q.items()} for q in p]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for t in range(1, steps + 1):
        leaves = [{k: v.clone().requires_grad_() for k, v in q.items()}
                  for q in p]
        loss = torch.nn.functional.cross_entropy(
            edge_list_forward(torch, feats, edges, leaves), labels)
        flat = [v for q in leaves for v in q.values()]
        grads = iter(torch.autograd.grad(loss, flat))
        losses.append(float(loss.detach()))
        for q, mq, vq in zip(p, m, v2):
            for k in q:
                gk = next(grads)
                mq[k] = b1 * mq[k] + (1 - b1) * gk
                vq[k] = b2 * vq[k] + (1 - b2) * gk * gk
                mh = mq[k] / (1 - b1 ** t)
                vh = vq[k] / (1 - b2 ** t)
                q[k] = q[k] - lr * mh / (torch.sqrt(vh) + eps)
    return losses


def phase_main(torch, graph, cfg, dec, counts: dict):
    """The forward path on ``dec``'s device: init_model, then forward with
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


def phase_kernels_train(torch, dec, errs: dict) -> None:
    """The training path's kernels against their plain versions on
    ``dec``'s device, adding the largest errors to ``errs``: the transposed
    read of block_diag_spmm (its backward), block_diag_spmm_fused (both
    reads), bell_spmm_fused, and bell_spmm_dw over the transpose payload and
    over the diagonal blocks (K = 1, identity columns, transposed read).
    dW's cotangent is unit-scale and dW is held to DW_REL_TOL of its
    largest entry."""
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(2)
    bd = dec.intra.formats["block_diag"]
    bell, bell_t = dec.sub("inter").formats["bell"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    bd_cases = [bd.blocks] + [randn(40, B, B) for B in (8, 32, 64)]
    main_bell = [(bell.blocks, bell.col_idx, bell.n_valid, bell.n_cols)]
    main_bell_t = [(bell_t.blocks, bell_t.col_idx, bell_t.n_valid,
                    bell_t.n_cols)]
    synth = [synthetic_bell(torch, gen, B, dev) for B in (8, 32, 64)]
    n_cases = 0

    def check(name, got, want, dtype, label=None):
        nonlocal n_cases
        sync(torch, dev)
        key = str(dtype).removeprefix("torch.")
        if name == "bell_spmm_dw":
            rel = dw_rel_err(got, want, f"{name} {key} {label}")
            errs[name][f"{key}_rel"] = max(errs[name].get(f"{key}_rel", 0.0),
                                           rel)
            extra = f", / max|dW| {rel:.3g}"
        else:
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            torch.testing.assert_close(got.float(), want.float(), **tol)
            extra = ""
        e = max_err(got, want)
        errs[name][key] = max(errs[name][key], e)
        if label is not None:
            log("kernel", f"{name} {key} {label}: max|err| {e:.3g}{extra}")
        n_cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        for Fi, Fo in WIDTHS:
            w = (randn(Fi, Fo) / Fi ** 0.5).to(dtype)
            for i, blocks in enumerate(bd_cases):
                blocks = blocks.to(dtype)
                n = blocks.shape[0] * blocks.shape[1]
                x = randn(n, Fi).to(dtype)
                g = randn(n, Fo).to(dtype)
                logged = i == 0
                check("bell_spmm_dw",
                      bellf_mod.bell_spmm_dw(blocks.unsqueeze(1), None, x, g,
                                             transpose=True),
                      bellf_mod.plain_dw(blocks.unsqueeze(1), None, x, g,
                                         transpose=True),
                      dtype, f"diag {Fi}x{Fo}" if logged else None)
                for with_y in (False, True):
                    y_in = randn(n, Fo).to(dtype) if with_y else None
                    yx = randn(n, Fi).to(dtype) if with_y else None
                    check("block_diag_spmm",
                          bd_mod.block_diag_spmm(blocks, x, yx,
                                                 transpose=True),
                          bd_mod.plain(blocks, x, yx, transpose=True), dtype,
                          f"transposed F={Fi} y_in={with_y}" if logged
                          else None)
                    for transpose in (False, True):
                        check("block_diag_spmm_fused",
                              bdf_mod.block_diag_spmm_fused(
                                  blocks, x, w, y_in, transpose=transpose),
                              bdf_mod.plain(blocks, x, w, y_in,
                                            transpose=transpose), dtype,
                              f"{Fi}x{Fo} y_in={with_y} "
                              f"transpose={transpose}" if logged else None)
            for i, (blocks, col_idx, n_valid, n_cols) in enumerate(
                    main_bell + synth):
                blocks = blocks.to(dtype)
                n_rows = blocks.shape[0] * blocks.shape[2]
                x = randn(n_cols, Fi).to(dtype)
                for with_y in (False, True):
                    y_in = randn(n_rows, Fo).to(dtype) if with_y else None
                    check("bell_spmm_fused",
                          bellf_mod.bell_spmm_fused(blocks, col_idx, x, w,
                                                    y_in, n_valid=n_valid),
                          bellf_mod.plain(blocks, col_idx, x, w, y_in),
                          dtype, f"{Fi}x{Fo} y_in={with_y}" if i == 0
                          else None)
            for i, (blocks, col_idx, n_valid, n_cols) in enumerate(
                    main_bell_t + synth):
                blocks = blocks.to(dtype)
                n_rows = blocks.shape[0] * blocks.shape[2]
                x = randn(n_rows, Fi).to(dtype)
                g = randn(n_cols, Fo).to(dtype)
                got = bellf_mod.bell_spmm_dw(blocks, col_idx, x, g,
                                             n_valid=n_valid)
                if i == 0 and not torch.equal(got, bellf_mod.bell_spmm_dw(
                        blocks, col_idx, x, g, n_valid=n_valid)):
                    raise RuntimeError("bell_spmm_dw gave other bits on a "
                                       "second run")
                check("bell_spmm_dw", got,
                      bellf_mod.plain_dw(blocks, col_idx, x, g), dtype,
                      f"bell_t {Fi}x{Fo} (same bits twice)" if i == 0
                      else None)
    log("kernel", f"{n_cases} training-path cases within tolerance "
        f"(main-path payloads and B in 8, 16, 32, 64); largest errors "
        f"{errs}")


def phase_grads(torch, graph, cfg, dec) -> None:
    """One loss.backward per plan on ``dec``'s device against the same on
    the CPU (plain versions), from the same parameters: every parameter's
    gradient within float32 1e-4."""
    from repro_torch.core import adaptgear, gnn
    dec_cpu = dec.to("cpu")
    feats = torch.from_numpy(graph.features)
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            feats.shape[1], graph.n_classes, device="cpu")
    for name, pair in PLANS.items():
        got = []
        for d in (dec, dec_cpu):
            x = adaptgear.to_reordered(d, feats.to(d.device))
            labels, mask = gnn.node_targets(graph, d)
            leaves = [{k: v.clone().to(d.device).requires_grad_()
                       for k, v in p.items()} for p in params]
            loss = gnn._loss(leaves, cfg, d, x, labels, mask, pair)
            loss.backward()
            got.append((float(loss.detach()), [
                {k: v.grad.cpu() for k, v in p.items()} for p in leaves]))
        (l_dev, g_dev), (l_cpu, g_cpu) = got
        worst, scale = 0.0, 0.0
        for i, (a, b) in enumerate(zip(g_dev, g_cpu)):
            for k in a:
                torch.testing.assert_close(a[k], b[k], **F32_TOL)
                worst = max(worst, max_err(a[k], b[k]))
                scale = max(scale, float(b[k].abs().max()))
        if abs(l_dev - l_cpu) > 1e-4 + 1e-4 * abs(l_cpu):
            raise RuntimeError(f"{name}: loss {l_dev} on the card, "
                               f"{l_cpu} on the CPU")
        log("grads", f"{name} {pair}: loss {l_dev:.6f} (cpu {l_cpu:.6f}); "
            f"max|grad diff| {worst:.3g} over 4 parameters, "
            f"largest |grad| {scale:.3g}")


def phase_train(torch, graph, cfg, counts: dict) -> dict:
    """The main path: gnn.train on the card for each plan from one
    parameter set, with the launch counts set to 0 just before and read
    just after.  Checks the counts against PER_STEP / PER_FORWARD and each
    curve against the CPU's, the edge-list GCN's and the other plan's."""
    import dataclasses
    import numpy as np
    from repro_torch.core import gnn
    params = gnn.init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                            graph.features.shape[1], graph.n_classes,
                            device="cpu")
    results, used = {}, {}
    for c in counts.values():
        c.reset()
    for name, pair in PLANS.items():
        before = {k: c.value for k, c in counts.items()}
        results[name] = gnn.train(
            graph, dataclasses.replace(cfg, fixed_kernels=pair),
            steps=TRAIN_STEPS, device="cuda", params=params)
        torch.cuda.synchronize()
        used[name] = {k: c.value - before[k] for k, c in counts.items()}
    launches = {k: c.value for k, c in counts.items()}
    log("train", f"launches over both runs {launches}")

    edge_losses = edge_list_train(torch, graph, params, TRAIN_STEPS, cfg.lr)
    for name, pair in PLANS.items():
        r = results[name]
        want = {k: TRAIN_STEPS * PER_STEP[name].get(k, 0)
                + PER_FORWARD[name].get(k, 0) for k in counts}
        if used[name] != want:
            raise RuntimeError(f"{name}: launches {used[name]}, expected "
                               f"{want} ({TRAIN_STEPS} steps and one "
                               "forward)")
        losses = np.asarray(r.losses)
        if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
            raise RuntimeError(f"{name}: losses {r.losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"{name}: the loss did not fall: {r.losses}")
        cpu = gnn.train(graph, dataclasses.replace(cfg, fixed_kernels=pair),
                        steps=TRAIN_STEPS, device="cpu", params=params)
        np.testing.assert_allclose(losses, cpu.losses, **CURVE_TOL)
        np.testing.assert_allclose(losses, edge_losses, **CURVE_TOL)
        log("train", f"{name} {pair}: {TRAIN_STEPS} steps, launches "
            f"{used[name]} = {TRAIN_STEPS} x {PER_STEP[name]} + one forward; "
            f"losses {losses[0]:.6f} -> {losses[-1]:.6f}, accuracy "
            f"{r.accuracy:.4f}, step {r.step_seconds * 1e3:.3f} ms (host "
            f"clock, loss read every step); max|card - cpu| "
            f"{np.abs(losses - cpu.losses).max():.3g}, max|card - edge-list "
            f"GCN| {np.abs(losses - edge_losses).max():.3g}")
    np.testing.assert_allclose(results["fused"].losses,
                               results["unfused"].losses, **CURVE_TOL)
    log("train", "fused and unfused curves agree: max|diff| "
        f"{np.abs(np.subtract(results['fused'].losses, results['unfused'].losses)).max():.3g}")
    return dict(results=results, launches=launches, params=params)


def time_train_kernels(torch, dec, flush, bsr, bsr_t) -> dict:
    """The training path's kernels at both layers' widths (L2 flushed),
    beside their plain versions, a library composite and their bounds."""
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    gen = torch.Generator(device="cuda").manual_seed(3)
    bd = dec.intra.formats["block_diag"]
    bell, bell_t = dec.sub("inter").formats["bell"]
    nb, B = bd.blocks.shape[0], bd.block_size
    Bb = bell.block_size
    nv, nv_t = int(bell.n_valid.sum()), int(bell_t.n_valid.sum())
    valid = (torch.arange(bell.max_blocks, device="cuda")[None, :]
             < bell.n_valid[:, None])
    n_src = int(torch.unique(bell.col_idx[valid]).numel()) * Bb
    n, be = dec.n_pad, 4
    rows = {k: {} for k in ("block_diag_spmm_fused", "bell_spmm_fused",
                            "bell_spmm_dw")}
    for Fi, Fo in WIDTHS[:2]:
        key = f"{Fi}x{Fo}"
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        w = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        g = torch.randn((n, Fo), generator=gen, device="cuda")
        bt1 = bd.blocks.unsqueeze(1)

        # block_diag_spmm_fused: every row transformed once
        lib = lambda: torch.bmm(bd.blocks, (x @ w).view(nb, B, Fo))  # noqa: E731
        torch.testing.assert_close(lib().view(n, Fo), bdf_mod.plain(
            bd.blocks, x, w), **F32_TOL)
        b_ms, b_by = bound((nb * B * B + n * Fi + Fi * Fo + n * Fo) * be,
                           2.0 * n * Fi * Fo + 2.0 * nb * B * B * Fo,
                           "float32")
        rows["block_diag_spmm_fused"][key] = dict(
            ms=graph_ms(torch, lambda: bdf_mod.block_diag_spmm_fused(
                bd.blocks, x, w), flush),
            plain_ms=graph_ms(torch, lambda: bdf_mod.plain(bd.blocks, x, w),
                              flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="torch.bmm(blocks, (x @ w).view(nb, B, Fo))",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bd.blocks.shape), [n, Fi], [Fi, Fo]])

        # bell_spmm_fused: the function reads each real block, each source
        # row of x and w once and writes y once, and transforms each source
        # row once (2 n_src Fi Fo flops); the kernel transforms a source
        # block once per stored block that names it (algo_bound_ms)
        io_bytes = (nv * (Bb * Bb * be + 4) + bell.n_brow * 4
                    + n_src * Fi * be + Fi * Fo * be + bell.n_rows * Fo * be)
        b_ms, b_by = bound(io_bytes, 2.0 * n_src * Fi * Fo
                           + 2.0 * nv * Bb * Bb * Fo, "float32")
        algo_ms, algo_by = bound(
            io_bytes, nv * (2.0 * Bb * Fi * Fo + 2.0 * Bb * Bb * Fo),
            "float32")
        lib_ms = None
        if bsr is not None:
            torch.testing.assert_close(bsr @ (x @ w), bellf_mod.plain(
                bell.blocks, bell.col_idx, x, w), **F32_TOL)
            lib_ms = eager_ms(torch, lambda: bsr @ (x @ w))
        rows["bell_spmm_fused"][key] = dict(
            ms=graph_ms(torch, lambda: bellf_mod.bell_spmm_fused(
                bell.blocks, bell.col_idx, x, w, n_valid=bell.n_valid), flush),
            plain_ms=graph_ms(torch, lambda: bellf_mod.plain(
                bell.blocks, bell.col_idx, x, w), flush),
            library_ms=lib_ms,
            library_call="torch BSR(real blocks) @ (x @ w), eager",
            bound_ms=b_ms, bound_by=b_by,
            algo_bound_ms=algo_ms, algo_bound_by=algo_by,
            shape=[list(bell.blocks.shape), [nv, "real blocks"],
                   [n_src, "source rows"], [n, Fi], [Fi, Fo]])

        # bell_spmm_dw over the transpose payload, and over the diagonal
        b_ms, b_by = bound(
            nv_t * (Bb * Bb * be + 4) + bell_t.n_brow * 4 + n * Fi * be
            + n * Fo * be + Fi * Fo * 4,
            nv_t * 2.0 * Bb * Bb * Fo + 2.0 * n * Fi * Fo, "float32")
        lib_ms = None
        if bsr_t is not None:
            dw_rel_err(x.T @ (bsr_t @ g), bellf_mod.plain_dw(
                bell_t.blocks, bell_t.col_idx, x, g), "x.T @ (bsr_t @ g)")
            lib_ms = eager_ms(torch, lambda: x.T @ (bsr_t @ g))
        rows["bell_spmm_dw"][key] = dict(
            ms=graph_ms(torch, lambda: bellf_mod.bell_spmm_dw(
                bell_t.blocks, bell_t.col_idx, x, g, n_valid=bell_t.n_valid),
                flush),
            plain_ms=graph_ms(torch, lambda: bellf_mod.plain_dw(
                bell_t.blocks, bell_t.col_idx, x, g), flush),
            library_ms=lib_ms,
            library_call="x.T @ (torch BSR(bell_t real blocks) @ g), eager",
            bound_ms=b_ms, bound_by=b_by,
            shape=[list(bell_t.blocks.shape), [nv_t, "real blocks"], [n, Fi],
                   [n, Fo]])
        lib = lambda: x.T @ torch.bmm(  # noqa: E731
            bd.blocks.transpose(1, 2), g.view(nb, B, Fo)).view(n, Fo)
        dw_rel_err(lib(), bellf_mod.plain_dw(bt1, None, x, g, transpose=True),
                   "x.T @ bmm(blocks^T, g)")
        b_ms, b_by = bound((nb * B * B + n * Fi + n * Fo) * be + Fi * Fo * 4,
                           2.0 * nb * B * B * Fo + 2.0 * n * Fi * Fo,
                           "float32")
        rows["bell_spmm_dw"][f"diag {key}"] = dict(
            ms=graph_ms(torch, lambda: bellf_mod.bell_spmm_dw(
                bt1, None, x, g, transpose=True), flush),
            plain_ms=graph_ms(torch, lambda: bellf_mod.plain_dw(
                bt1, None, x, g, transpose=True), flush),
            library_ms=graph_ms(torch, lib, flush),
            library_call="x.T @ torch.bmm(blocks^T, g.view(nb, B, Fo))",
            bound_ms=b_ms, bound_by=b_by,
            shape=[[nb, 1, B, B], [n, Fi], [n, Fo]])
        for k in rows:
            for kk in (key, f"diag {key}"):
                r = rows[k].get(kk)
                if r is None:
                    continue
                lib_s = (f"{r['library_ms']:.4f}" if r["library_ms"]
                         is not None else "null")
                log("timing", f"{k} {kk}: {r['ms']:.4f} ms (L2 cold), plain "
                    f"{r['plain_ms']:.4f} ms, library {lib_s} ms "
                    f"({r['library_call']}), bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']})" + (
                        f"; with the kernel's recompute "
                        f"{r['algo_bound_ms']:.4f} ms ({r['algo_bound_by']})"
                        if "algo_bound_ms" in r else ""))
    return rows


def profile_busy(torch, fn, iters: int, median_ms: float, what: str):
    """Device time per call of ``fn`` from torch.profiler, its top kernels,
    and its share of ``median_ms``; None where the profiler saw no device
    time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    dev_rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev_rows.append((us / iters, e.count // iters, e.key))
    dev_rows.sort(reverse=True)
    for us, cnt, key in dev_rows[:10]:
        log("profile", f"{us:9.1f} us/{what}  x{cnt}  {key[:90]}")
    busy_us = sum(r[0] for r in dev_rows)
    if busy_us <= 0:
        log("profile", f"the profiler recorded no device time: device-busy "
            f"share of a {what} not measured")
        return None
    busy = dict(busy_us=busy_us, share_of_profiled_wall=busy_us / wall_us,
                share_of_median=busy_us / (median_ms * 1e3))
    log("profile", f"device busy {busy_us:.1f} us per {what}: "
        f"{100 * busy['share_of_median']:.1f} % of the median {what} "
        f"({median_ms * 1e3:.1f} us), {100 * busy['share_of_profiled_wall']:.1f}"
        f" % of the profiled wall ({wall_us:.1f} us)")
    return busy


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

    import dataclasses
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as graph_mod
    from repro_torch.kernels import bell_spmm as bell_mod
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    from repro_torch.kernels import block_diag_spmm as bd_mod
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    counts = {"block_diag_spmm": bd_mod.launches,
              "bell_spmm": bell_mod.launches,
              "block_diag_spmm_fused": bdf_mod.launches,
              "bell_spmm_fused": bellf_mod.launches,
              "bell_spmm_dw": bellf_mod.dw_launches}

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
        f"blocks), bell_t {tuple(bell_t.blocks.shape)} "
        f"({int(bell_t.n_valid.sum())} real blocks)")

    # 2. kernels against their plain versions --------------------------------
    errs = phase_kernels(torch, dec)
    phase_kernels_train(torch, dec, errs)

    # 3. forward -------------------------------------------------------------
    plan, params, x, launches_fwd = phase_main(torch, graph, cfg, dec, counts)
    n_fwd = 2
    for k, v in launches_fwd.items():
        want = 2 * n_fwd if k in FORWARD_KERNELS else 0
        if v != want:
            raise RuntimeError(f"{k} launched {v} times in {n_fwd} "
                               f"forwards, expected {want}")

    # 4. gradients, 5. training (the main path) ------------------------------
    phase_grads(torch, graph, cfg, dec)
    trained = phase_train(torch, graph, cfg, counts)
    launches = trained["launches"]

    # 4. timing --------------------------------------------------------------
    fwd_ms = {acc: eager_ms(torch, lambda acc=acc: gnn.forward(
        params, cfg, dec, x, plan, acc=acc)) for acc in (False, True)}
    log("timing", f"forward median (CUDA events, host launch included): "
        f"acc=False {fwd_ms[False]:.4f} ms, acc=True {fwd_ms[True]:.4f} ms")

    # one training step per plan, in turns (unfused, fused, fused, unfused)
    labels, mask = gnn.node_targets(graph, dec)
    p0 = [{k: v.cuda() for k, v in q.items()} for q in trained["params"]]
    steps = {name: gnn.make_train_step(
        dataclasses.replace(cfg, fixed_kernels=pair), dec, pair)
        for name, pair in PLANS.items()}
    opt0 = gnn._adam_init(p0)
    step_runs = {name: [] for name in PLANS}
    for name in ("unfused", "fused", "fused", "unfused"):
        step_runs[name].append(eager_ms(torch, lambda name=name: steps[name](
            p0, opt0, x, labels, mask)))
    step_ms = {name: statistics.mean(v) for name, v in step_runs.items()}
    log("timing", "training step median (CUDA events, host launch "
        "included; two runs each, in turns): " + ", ".join(
            f"{n} {step_runs[n][0]:.4f} / {step_runs[n][1]:.4f} ms"
            for n in PLANS))

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
    rows.update(time_train_kernels(torch, dec, flush, bsr,
                                   bsr_of(torch, bell_t)))
    del scratch

    busy = profile_busy(torch, lambda: gnn.forward(params, cfg, dec, x, plan),
                        5, fwd_ms[False], "forward")
    busy_step = {name: profile_busy(
        torch, lambda name=name: steps[name](p0, opt0, x, labels, mask), 5,
        step_ms[name], f"{name} step") for name in PLANS}

    out = []
    for name, meta in KERNELS.items():
        key = 16 if name in FORWARD_KERNELS else "500x16"
        r = rows[name][key]
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            launches_per_step={p: PER_STEP[p].get(name, 0) for p in PLANS},
            launches_forward=launches_fwd[name],
            max_abs_err=errs[name]["float32"],
            max_abs_err_bf16=errs[name]["bfloat16"],
            **({"max_rel_err": errs[name]["float32_rel"],
                "max_rel_err_bf16": errs[name]["bfloat16_rel"]}
               if name == "bell_spmm_dw" else {}),
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            dtype="float32", width=key,
            by_width={str(k): v for k, v in rows[name].items()}))
    log("done", f"{time.perf_counter() - t_start:.1f} s; forward_ms "
        f"{ {str(k): v for k, v in fwd_ms.items()} }; busy {busy}; "
        f"step_ms {step_ms}; busy per step {busy_step}; train losses "
        + json.dumps({n: r.losses for n, r in trained["results"].items()}))
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
