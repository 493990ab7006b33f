"""The redesigned gather kernels, the bf16 flash_attention path and the
two scans alone on the card.

Builds only the sources named by ``--kernels`` (by default all nine:
``csrc/bell_spmm.cu``, ``csrc/tcgnn_spmm_dw.cu``,
``csrc/tcgnn_spmm_fused.cu``, ``csrc/tcgnn_spmm.cu``,
``csrc/block_diag_spmm_dual.cu``, ``csrc/block_diag_spmm.cu``,
``csrc/flash_attention.cu``, ``csrc/rwkv6_chunked.cu`` and
``csrc/mamba_scan.cu``), prepares the pubmed
graph as ``chip_smoke.py`` does where a gather kernel is named (and its
SAGE decomposition for the dual kernel), and holds each kernel against its
plain version, float32 and bfloat16, then times it (CUDA graphs, L2
flushed) beside its library yardstick and bound, and probes what bounds it:

- bell_spmm on pubmed's forward and transpose payloads (``bell``,
  ``bell_t``: the backward's dX pass) at F in {3, 16, 64, 500}, y_in on and
  off, n_valid given and null, and on synthetic payloads (B in 8, 32, 64);
  timed at F = 16 and 3 on both payloads beside the BSR product; probes:
  L2 warm, F = 64 (the gathered X grows, the block bytes stay);
- tcgnn_spmm_dw on pubmed's transpose payload and synthetic ones (B in 8,
  32, 64) at (500, 16), (16, 3), (3, 16) and (1100, 65), the same bits
  twice; timed at 500x16 and 16x3 beside ``x.T @ bmm(tiles_t,
  g[gather_idx_t])``; probes: L2 warm, Fi = 32 and 128;
- tcgnn_spmm_fused on pubmed's payloads and synthetic ones (B in 8, 32,
  64), at the main path's widths, y_in on and off; timed at 500x16 and 16x3
  and the dX pass 3x16 beside ``bmm(tiles, (x@w)[gather_idx])``; probe at
  500x16: L2 warm, Fi = 32 and 128;
- tcgnn_spmm on pubmed's forward and transpose payloads (``tc``, ``tc_t``:
  the backward's dX pass) and synthetic ones (B in 8, 32, 64, C = 256) at F
  in {3, 16, 64, 500}, y_in on and off, the same bits twice; timed at F =
  16 and 3 on both payloads beside ``bmm(tiles, x[gather_idx])``; probes:
  L2 warm, F = 64 (two column tiles);
- block_diag_spmm_dual at ``chip_smoke.phase_kernels_dual``'s cases and
  gates (pubmed's SAGE blocks, B in 8, 32, 64, both layers' widths, the
  backward), then the same bits twice; timed at 500x16 and 16x3 beside
  ``bmm(A, x@w) + x@w_self``; probes: L2 warm, and what one launch costs
  (a PyTorch fill of one float, timed the same way);
- block_diag_spmm on pubmed's diagonal blocks and synthetic ones (B in 8,
  32, 64) at F in {1, 3, 16, 17, 64, 65, 500}, y_in none, full and a bias
  row (strides (0, 1)), both reads, x on and off 16-byte boundaries, the
  same bits twice; timed at F = 16 and 3 (the forward, the transposed
  read, the bias row and a full y_in) beside ``torch.bmm`` /
  ``torch.baddbmm``; probes: L2 warm, what one launch costs, and what
  one elementwise pass over the same bytes costs (``torch.add`` of the
  blocks, as rows of 16, and X at F = 16);
- flash_attention at ``chip_smoke.phase_kernels_flash``'s cases and gates;
  timed bf16 causal at ``chip_smoke.FLASH_TIMED`` beside SDPA;
- rwkv6_chunked at ``chip_smoke.phase_kernels_rwkv``'s cases and gates;
  timed at ``chip_smoke.RWKV_TIMED`` (bf16, and float32 at batch 4) beside
  its bound, the same bits twice; probe: L2 warm (the second shape is
  batch 1);
- mamba_scan at ``chip_smoke.phase_kernels_mamba``'s cases and gates;
  timed float32 at ``chip_smoke.MAMBA_TIMED`` beside its bound, the same
  bits twice; probes: L2 warm, a bfloat16 x (the second shape is batch 1).

With ``--baseline DIR`` (a checkout of another commit) it also builds that
commit's sources of the chosen kernels and times them in turns with these
(baseline, this tree, this tree, baseline) on the same inputs.  Needs one
CUDA card and nvcc; exits 1 without them.  From the root of a checkout:

    python3 tools/port_kernels_bench.py [--kernels bell_spmm,tcgnn_spmm_dw]
        [--baseline DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SOURCES = ("bell_spmm", "tcgnn_spmm_dw", "tcgnn_spmm_fused", "tcgnn_spmm",
           "block_diag_spmm_dual", "block_diag_spmm", "flash_attention",
           "rwkv6_chunked", "mamba_scan")
GATHER = SOURCES[:6]     # the kernels timed on pubmed's payloads
# (payload, Fi, Fo) of the timed tcgnn_spmm_fused calls: layer 1, layer 2,
# and layer 2's dX pass over the transpose payload with W^T
TCGNN_TIMED = {"500x16": (0, 500, 16), "16x3": (0, 16, 3),
               "3x16 dX": (1, 3, 16)}


def build_baseline(root: Path, names) -> dict:
    """The sources ``names`` of the checkout at ``root``, built side by side
    with nvcc and loaded (``{name: _build.Built}``)."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        so = _build.BUILD_DIR / f"lib{name}-baseline.so"
        procs[name] = (src, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (src, so, proc) in procs.items():
        o, e = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the baseline {name}:\n{o}{e}")
        out[name] = _build._load(name, so, 0.0, ())
        getattr(out[name].lib, f"{name}_launch").argtypes = launch_argtypes(
            src.read_text(), name)
    return out


def launch_argtypes(source: str, name: str) -> list:
    """ctypes argtypes of ``<name>_launch`` as ``source`` declares it (a
    baseline's interface may differ from this tree's ``_build.SIGNATURES``)."""
    decl = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', source)
    types = []
    for param in decl.group(1).split(","):
        words = param.replace("*", " * ").split()
        types.append(ctypes.c_void_p if "*" in words else
                     ctypes.c_float if "float" in words else ctypes.c_int)
    return types


def in_turns(torch, new, base, flush) -> dict:
    """Times ``new`` alone, or baseline, new, new, baseline."""
    if base is None:
        return {"ms": cs.graph_ms(torch, new, flush)}
    t = [cs.graph_ms(torch, f, flush) for f in (base, new, new, base)]
    return {"ms": (t[1] + t[2]) / 2, "ms_runs": [t[1], t[2]],
            "baseline_ms": (t[0] + t[3]) / 2, "baseline_runs": [t[0], t[3]]}


def check_tcgnn(torch, dec) -> dict:
    """tcgnn_spmm_fused against its plain version; the largest errors."""
    from repro_torch.kernels import tcgnn_tile as tc_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(4)
    tc, tc_t = dec.sub("inter").formats["tcgnn_tile"]
    cases = [(tc.tiles, tc.gather_idx), (tc_t.tiles, tc_t.gather_idx)] + [
        cs.synthetic_tcgnn(torch, gen, B, dev) for B in (8, 32, 64)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        tol = cs.F32_TOL if dtype == torch.float32 else cs.BF16_TOL
        for tiles, gi in cases:
            n = tiles.shape[0] * tiles.shape[1]
            for Fi, Fo in cs.WIDTHS:
                x = torch.randn((n, Fi), generator=gen, device=dev).to(dtype)
                w = (torch.randn((Fi, Fo), generator=gen, device=dev)
                     / Fi ** 0.5).to(dtype)
                for with_y in (False, True):
                    y_in = (torch.randn((n, Fo), generator=gen, device=dev)
                            .to(dtype) if with_y else None)
                    got = tc_mod.tcgnn_spmm_fused(tiles, gi, x, w, y_in)
                    again = tc_mod.tcgnn_spmm_fused(tiles, gi, x, w, y_in)
                    want = tc_mod.plain_fused(tiles, gi, x, w, y_in)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise RuntimeError("tcgnn_spmm_fused gave other bits "
                                           "on a second call")
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                    errs[key] = max(errs[key], cs.max_err(got, want))
    cs.log("kernel", f"tcgnn_spmm_fused: {len(cases) * 12} cases within "
           f"tolerance, same bits twice; largest errors {errs}")
    return errs


def time_tcgnn(torch, dec, flush, base) -> dict:
    """tcgnn_spmm_fused at TCGNN_TIMED beside bmm(tiles, (x@w)[gi]) and
    its bound (as chip_smoke.time_tcgnn_kernels), then the 500x16 probe."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcgnn_tile as tc_mod
    gen = torch.Generator(device="cuda").manual_seed(5)
    payloads = dec.sub("inter").formats["tcgnn_tile"]
    n = dec.n_pad
    rows = {}

    def kernel_of(p, x, w):
        return lambda: tc_mod.tcgnn_spmm_fused(p.tiles, p.gather_idx, x, w)

    def baseline_of(p, x, w):
        y = torch.empty((n, w.shape[1]), device="cuda")
        nbr, B, C = p.tiles.shape
        return lambda: base.launch(
            p.tiles.data_ptr(), p.gather_idx.data_ptr(), x.data_ptr(),
            w.data_ptr(), None, y.data_ptr(), nbr, B, C, w.shape[0],
            w.shape[1], 0, _build.stream(x))

    for key, (which, Fi, Fo) in TCGNN_TIMED.items():
        p = payloads[which]
        gi = p.gather_idx.long()
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        w = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        lib = lambda: torch.bmm(p.tiles, (x @ w)[gi])  # noqa: E731
        want = tc_mod.plain_fused(p.tiles, p.gather_idx, x, w)
        torch.testing.assert_close(lib().view(n, Fo), want, **cs.F32_TOL)
        torch.testing.assert_close(kernel_of(p, x, w)(), want, **cs.F32_TOL)
        real = int(tc_mod.real_slots(p.tiles).sum())
        b_ms, b_by = cs.tcgnn_fused_bound(torch, p, n, Fi, Fo)
        r = in_turns(torch, kernel_of(p, x, w),
                     baseline_of(p, x, w) if base is not None else None,
                     flush)
        r.update(library_ms=cs.graph_ms(torch, lib, flush),
                 library_call="torch.bmm(tiles, (x @ w)[gather_idx])",
                 bound_ms=b_ms, bound_by=b_by, real_slots=real,
                 gathered_mb=real * Fi * 4 / 1e6)
        rows[key] = r
        cs.log("timing", f"tcgnn_spmm_fused {key}: {json.dumps(r)}")

    # the probe: L2 warm, and the gathered bytes cut with Fi
    p = payloads[0]
    probe = {}
    for name, Fi, fl in (("flushed", 500, flush), ("warm_l2", 500, None),
                         ("fi_32", 32, flush), ("fi_128", 128, flush)):
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        w = torch.randn((Fi, 16), generator=gen, device="cuda") / Fi ** 0.5
        torch.testing.assert_close(kernel_of(p, x, w)(), tc_mod.plain_fused(
            p.tiles, p.gather_idx, x, w), **cs.F32_TOL)
        probe[name] = cs.graph_ms(torch, kernel_of(p, x, w), fl)
        cs.log("probe", f"tcgnn_spmm_fused 500x16 {name}: "
               f"{probe[name]:.4f} ms")
    return {"rows": rows, "probe": probe}


# (payload, F) of the timed tcgnn_spmm calls: layers 1 and 2 forward over
# tc, and their dX passes over tc_t
TCGNN_SPMM_TIMED = {"tc F=16": (0, 16), "tc F=3": (0, 3),
                    "tc_t F=16": (1, 16), "tc_t F=3": (1, 3)}


def check_tcgnn_spmm(torch, dec) -> dict:
    """tcgnn_spmm against its plain version, the same bits twice; the
    largest errors."""
    from repro_torch.kernels import tcgnn_tile as tc_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(11)
    tc, tc_t = dec.sub("inter").formats["tcgnn_tile"]
    cases = [(tc.tiles, tc.gather_idx), (tc_t.tiles, tc_t.gather_idx)] + [
        cs.synthetic_tcgnn(torch, gen, B, dev) for B in (8, 32, 64)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        tol = cs.F32_TOL if dtype == torch.float32 else cs.BF16_TOL
        for tiles, gi in cases:
            n = tiles.shape[0] * tiles.shape[1]
            for F in (3, 16, 64, 500):
                x = torch.randn((n, F), generator=gen, device=dev).to(dtype)
                for with_y in (False, True):
                    y_in = (torch.randn((n, F), generator=gen, device=dev)
                            .to(dtype) if with_y else None)
                    got = same_bits(torch, lambda: tc_mod.tcgnn_spmm(
                        tiles, gi, x, y_in), "tcgnn_spmm")
                    want = tc_mod.plain(tiles, gi, x, y_in)
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                    errs[key] = max(errs[key], cs.max_err(got, want))
                    n_cases += 1
    cs.log("kernel", f"tcgnn_spmm: {n_cases} cases within tolerance, same "
           f"bits twice; largest errors {errs}")
    return errs


def time_tcgnn_spmm(torch, dec, flush, base) -> dict:
    """tcgnn_spmm at TCGNN_SPMM_TIMED beside bmm(tiles, x[gi]) and its
    bound (as chip_smoke.time_tcgnn_kernels), in turns with the baseline;
    then the probe: L2 warm, and F = 64."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcgnn_tile as tc_mod
    gen = torch.Generator(device="cuda").manual_seed(12)
    payloads = dec.sub("inter").formats["tcgnn_tile"]
    n = dec.n_pad
    rows = {}

    def kernel_of(p, x):
        return lambda: tc_mod.tcgnn_spmm(p.tiles, p.gather_idx, x)

    def baseline_of(p, x):
        y = torch.empty((n, x.shape[1]), device="cuda")
        nbr, B, C = p.tiles.shape

        def run():
            base.launch(p.tiles.data_ptr(), p.gather_idx.data_ptr(),
                        x.data_ptr(), None, y.data_ptr(), nbr, B, C,
                        x.shape[1], 0, _build.stream(x))
            return y
        return run

    for key, (which, F) in TCGNN_SPMM_TIMED.items():
        p = payloads[which]
        gi = p.gather_idx.long()
        x = torch.randn((n, F), generator=gen, device="cuda")
        lib = lambda: torch.bmm(p.tiles, x[gi])  # noqa: E731
        want = tc_mod.plain(p.tiles, p.gather_idx, x)
        torch.testing.assert_close(lib().view(n, F), want, **cs.F32_TOL)
        torch.testing.assert_close(kernel_of(p, x)(), want, **cs.F32_TOL)
        old = None
        if base is not None:
            old = baseline_of(p, x)
            torch.testing.assert_close(old(), want, **cs.F32_TOL)
        b_ms, b_by = cs.tcgnn_spmm_bound(torch, p, n, F)
        r = in_turns(torch, kernel_of(p, x), old, flush)
        r.update(library_ms=cs.graph_ms(torch, lib, flush),
                 library_call="torch.bmm(tiles, x[gather_idx])",
                 bound_ms=b_ms, bound_by=b_by,
                 real_slots=int(tc_mod.real_slots(p.tiles).sum()))
        rows[key] = r
        cs.log("timing", f"tcgnn_spmm {key}: {json.dumps(r)}")

    p = payloads[0]
    probe = {}
    for name, F, fl in (("flushed", 16, flush), ("warm_l2", 16, None),
                        ("f_64", 64, flush), ("f_64_warm_l2", 64, None)):
        x = torch.randn((n, F), generator=gen, device="cuda")
        torch.testing.assert_close(kernel_of(p, x)(), tc_mod.plain(
            p.tiles, p.gather_idx, x), **cs.F32_TOL)
        probe[name] = cs.graph_ms(torch, kernel_of(p, x), fl)
        cs.log("probe", f"tcgnn_spmm tc {name}: {probe[name]:.4f} ms")
    probe["f_64_bound_ms"] = cs.tcgnn_spmm_bound(torch, p, n, 64)[0]
    return {"rows": rows, "probe": probe}


def time_dual(torch, sdec, flush, base) -> dict:
    """block_diag_spmm_dual on pubmed's SAGE diagonal blocks at both
    layers' widths beside bmm(A, x@w) + x@w_self and its bound (as
    chip_smoke.time_dual_kernel), in turns with the baseline, the same bits
    twice; probes: L2 warm, and one launch's cost."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_diag_spmm_fused as bdf_mod
    gen = torch.Generator(device="cuda").manual_seed(13)
    blocks = sdec.intra.formats["block_diag"].blocks
    nb, B = blocks.shape[0], blocks.shape[1]
    n = sdec.n_pad
    rows = {}
    for Fi, Fo in cs.WIDTHS[:2]:
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        w = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        ws = torch.randn((Fi, Fo), generator=gen, device="cuda") / Fi ** 0.5
        lib = lambda: (torch.bmm(blocks, (x @ w).view(nb, B, Fo))  # noqa: E731
                       .view(n, Fo) + x @ ws)
        new = lambda: bdf_mod.block_diag_spmm_dual(  # noqa: E731
            blocks, x, w, ws)
        want = bdf_mod.plain_dual(blocks, x, w, ws)
        torch.testing.assert_close(lib(), want, **cs.F32_TOL)
        torch.testing.assert_close(same_bits(torch, new, "dual"), want,
                                   **cs.F32_TOL)
        old = None
        if base is not None:
            y = torch.empty((n, Fo), device="cuda")

            def old():
                base.launch(blocks.data_ptr(), x.data_ptr(), w.data_ptr(),
                            ws.data_ptr(), None, y.data_ptr(), nb, B, Fi, Fo,
                            0, _build.stream(x))
                return y
            torch.testing.assert_close(old(), want, **cs.F32_TOL)
        b_ms, b_by = cs.bound((nb * B * B + n * Fi + 2 * Fi * Fo + n * Fo)
                              * 4, 4.0 * n * Fi * Fo + 2.0 * nb * B * B * Fo,
                              "float32")
        r = in_turns(torch, new, old, flush)
        r.update(warm_l2_ms=cs.graph_ms(torch, new),
                 library_ms=cs.graph_ms(torch, lib, flush),
                 library_call="torch.bmm(blocks, (x @ w).view(nb, B, Fo)) "
                              "+ x @ w_self",
                 bound_ms=b_ms, bound_by=b_by)
        key = f"{Fi}x{Fo}"
        rows[key] = r
        cs.log("timing", f"block_diag_spmm_dual {key}: {json.dumps(r)}")
    one = torch.zeros(1, device="cuda")
    floor = {"fill_one_float_ms": cs.graph_ms(torch, one.zero_, flush)}
    cs.log("probe", f"one launch (L2 flushed): {json.dumps(floor)}")
    return {"rows": rows, "probe": floor}


def check_block_diag(torch, dec) -> dict:
    """block_diag_spmm against its plain version over pubmed's blocks and
    synthetic ones (B in 8, 32, 64) at F in {1, 3, 16, 17, 64, 65, 500},
    y_in none, full and one bias row repeated, both reads, x on and off
    16-byte boundaries; the same bits twice; the largest errors."""
    from repro_torch.kernels import block_diag_spmm as bd_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(31)
    cases = [dec.intra.formats["block_diag"].blocks] + [
        torch.randn((37, B, B), generator=gen, device=dev)
        for B in (8, 32, 64)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        tol = cs.F32_TOL if dtype == torch.float32 else cs.BF16_TOL
        for blocks in cases:
            blocks = blocks.to(dtype)
            rows = blocks.shape[0] * blocks.shape[1]
            for F in (1, 3, 16, 17, 64, 65, 500):
                buf = torch.randn((rows * F + 1,), generator=gen,
                                  device=dev).to(dtype)
                y_ins = (None, torch.randn((rows, F), generator=gen,
                                           device=dev).to(dtype),
                         torch.randn((F,), generator=gen, device=dev)
                         .to(dtype).expand(rows, F))
                # rows on 16-byte boundaries where F allows, and one
                # element off them
                for x in (buf[:-1].view(rows, F), buf[1:].view(rows, F)):
                    for y_in in y_ins:
                        for transpose in (False, True):
                            got = same_bits(torch, lambda: (
                                bd_mod.block_diag_spmm(
                                    blocks, x, y_in, transpose=transpose)),
                                "block_diag_spmm")
                            want = bd_mod.plain(blocks, x, y_in,
                                                transpose=transpose)
                            torch.testing.assert_close(
                                got.float(), want.float(), **tol)
                            errs[key] = max(errs[key], cs.max_err(got, want))
                            n += 1
    cs.log("kernel", f"block_diag_spmm: {n} cases within tolerance, same "
           f"bits twice; largest errors {errs}")
    return errs


def time_block_diag(torch, dec, flush, base) -> dict:
    """block_diag_spmm on pubmed's diagonal blocks at F = 16 and 3: the
    forward, the transposed read, the bias row as y_in and a full y_in,
    beside torch.bmm / torch.baddbmm and the bound (as chip_smoke.py's row
    1), in turns with the baseline (whose bias-row call includes the (n,
    F) copy its path made); probes: L2 warm, one launch's cost, and one
    elementwise pass over the same bytes at F = 16 (torch.add of the blocks,
    as n rows of 16, and X)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_diag_spmm as bd_mod
    gen = torch.Generator(device="cuda").manual_seed(32)
    blocks = dec.intra.formats["block_diag"].blocks
    nb, B = blocks.shape[0], blocks.shape[1]
    n = nb * B
    rows = {}
    for F in (16, 3):
        x = torch.randn((n, F), generator=gen, device="cuda")
        xb = x.view(nb, B, F)
        bias = torch.randn((F,), generator=gen, device="cuda")
        full = torch.randn((n, F), generator=gen, device="cuda")
        y = torch.empty((n, F), device="cuda")
        timed = {
            "fwd": (None, False, lambda: torch.bmm(blocks, xb),
                    "torch.bmm(blocks, x.view(nb, B, F))"),
            "t": (None, True, lambda: torch.bmm(blocks.transpose(1, 2), xb),
                  "torch.bmm(blocks.transpose(1, 2), x.view(nb, B, F))"),
            "bias": (bias.expand(n, F), False,
                     lambda: torch.baddbmm(bias, blocks, xb),
                     "torch.baddbmm(bias, blocks, x.view(nb, B, F))"),
            "full": (full, False,
                     lambda: torch.baddbmm(full.view(nb, B, F), blocks, xb),
                     "torch.baddbmm(y_in.view(nb, B, F), blocks, "
                     "x.view(nb, B, F))")}
        for what, (y_in, transpose, lib, lib_call) in timed.items():
            def new(y_in=y_in, transpose=transpose):
                return bd_mod.block_diag_spmm(blocks, x, y_in,
                                              transpose=transpose)
            want = bd_mod.plain(blocks, x, y_in, transpose=transpose)
            torch.testing.assert_close(lib().view(n, F), want, **cs.F32_TOL)
            torch.testing.assert_close(same_bits(torch, new,
                                                 f"block_diag_spmm {what}"),
                                       want, **cs.F32_TOL)
            old = None
            if base is not None:
                def old(y_in=y_in, transpose=transpose):
                    yi = None if y_in is None else y_in.contiguous()
                    base.launch(blocks.data_ptr(), x.data_ptr(),
                                _build.ptr(yi), y.data_ptr(), nb, B, F,
                                int(transpose), 0, _build.stream(x))
                    return y
                torch.testing.assert_close(old(), want, **cs.F32_TOL)
            b_ms, b_by = cs.block_diag_bound(nb, B, F, {
                "bias": "row", "full": "full"}.get(what, "none"))
            r = in_turns(torch, new, old, flush)
            r.update(library_ms=cs.graph_ms(torch, lib, flush),
                     library_call=lib_call, bound_ms=b_ms, bound_by=b_by)
            key = f"{what} F={F}"
            rows[key] = r
            cs.log("timing", f"block_diag_spmm {key}: {json.dumps(r)}")
    x = torch.randn((n, 16), generator=gen, device="cuda")
    one = torch.zeros(1, device="cuda")
    probe = {"warm_l2_ms": cs.graph_ms(
                 torch, lambda: bd_mod.block_diag_spmm(blocks, x)),
             "fill_one_float_ms": cs.graph_ms(torch, one.zero_, flush)}
    if B == 16:
        # one elementwise pass over the forward's bytes at F = 16: it reads
        # the blocks (as n rows of 16) and X and writes Y, as the kernel does
        y = torch.empty((n, 16), device="cuda")
        a_rows = blocks.view(n, 16)
        probe["same_bytes_add_ms"] = cs.graph_ms(
            torch, lambda: torch.add(a_rows, x, out=y), flush)
    cs.log("probe", f"block_diag_spmm F=16: {json.dumps(probe)}")
    return {"rows": rows, "probe": probe}


def time_flash(torch, flush, base) -> dict:
    """flash_attention bf16 causal at FLASH_TIMED beside SDPA and its
    bound (as chip_smoke.time_flash_kernel)."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for B, Hq, Hkv, S, d in cs.FLASH_TIMED:
        q, k, v = (torch.randn((B, h, S, d), generator=gen, device="cuda")
                   .bfloat16() for h in (Hq, Hkv, Hkv))
        o = torch.empty_like(q)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
        new = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        old = None
        if base is not None:
            old = lambda: base.launch(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                Hq, Hkv, S, S, d, d, 1, d ** -0.5, 1, _build.stream(q))
        want = fa.plain(q, k, v)
        cs.check_flash_close(torch, new(), want, f"flash {B}x{Hq}x{S}x{d}")
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        b_ms, b_by = cs.bound(n_bytes, fa.flash_flops(B, Hq, S, S, d),
                              "bfloat16")
        r = in_turns(torch, new, old, flush)
        r.update(library_ms=cs.graph_ms(torch, lib, flush),
                 library_call="F.scaled_dot_product_attention(q, k, v, "
                              "is_causal=True, enable_gqa=True)",
                 bound_ms=b_ms, bound_by=b_by,
                 tflops=fa.flash_flops(B, Hq, S, S, d) / r["ms"] / 1e9)
        key = f"{B}x{Hq}x{Hkv}x{S}x{d}"
        rows[key] = r
        cs.log("timing", f"flash_attention {key} bf16: {json.dumps(r)}")
    return rows


def same_bits(torch, fn, what: str):
    """``fn()``, after checking that a second call gives the same bits."""
    got = fn()
    if not torch.equal(got, fn()):
        raise RuntimeError(f"{what} gave other bits on a second call")
    return got


def time_rwkv(torch, flush, base) -> dict:
    """rwkv6_chunked at RWKV_TIMED (bf16, and float32 at the first shape)
    beside its bound (as chip_smoke.time_rwkv_kernel), in turns with the
    baseline; probe: L2 warm."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_chunked as rk
    gen = torch.Generator(device="cuda").manual_seed(24)
    rows = {}
    for i, (B, H, T, dh) in enumerate(cs.RWKV_TIMED):
        for dtype in (torch.bfloat16, torch.float32)[:2 if i == 0 else 1]:
            name = str(dtype).removeprefix("torch.")
            args = cs.rwkv_inputs(torch, gen, B, H, T, dh, dtype, "rand")
            r, k, v, w, u = args
            new = lambda: rk.rwkv6_chunked_kernel(*args, chunk=128)  # noqa: E731
            got = same_bits(torch, new, f"rwkv6_chunked {name}")
            old, diff = None, None
            if base is not None:
                o = torch.empty_like(r)
                code = _build.cuda_dtype_code((r, k, v))

                def old():
                    base.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                w.data_ptr(), u.data_ptr(), o.data_ptr(), B,
                                H, T, dh, code, _build.stream(r))
                    return o
                diff = cs.max_err(got, old())
            n_bytes = (4 * r.numel() * r.element_size() + w.numel() * 4
                       + u.numel() * 4)
            b_ms, b_by = cs.bound(n_bytes, rk.rwkv6_flops(
                B, H, T, dh, chunk=rk.KERNEL_CHUNK), name)
            row = in_turns(torch, new, old, flush)
            row.update(warm_l2_ms=cs.graph_ms(torch, new), bound_ms=b_ms,
                       bound_by=b_by, max_diff_vs_baseline=diff)
            key = f"{B}x{H}x{T}x{dh} {name}"
            rows[key] = row
            cs.log("timing", f"rwkv6_chunked {key}: {json.dumps(row)}")
    return rows


def time_mamba(torch, flush, base) -> dict:
    """mamba_scan float32 at MAMBA_TIMED beside its bound (as
    chip_smoke.time_mamba_kernel), in turns with the baseline; probes: L2
    warm, a bfloat16 x."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_scan as ms
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = {}
    for B, T, di, ds in cs.MAMBA_TIMED:
        args = cs.mamba_inputs(torch, gen, B, T, di, ds, 0.1)
        x, dt, Bc, Cc, A, D = args
        xb = x.bfloat16()
        new = lambda: ms.mamba_scan(*args)  # noqa: E731
        got = same_bits(torch, new, "mamba_scan")
        old, diff = None, None
        if base is not None:
            y = torch.empty_like(x)

            def old():
                base.launch(x.data_ptr(), dt.data_ptr(), Bc.data_ptr(),
                            Cc.data_ptr(), A.data_ptr(), D.data_ptr(),
                            y.data_ptr(), B, T, di, ds, 0, _build.stream(x))
                return y
            diff = cs.max_err(got, old())
        n_bytes = sum(a.numel() * a.element_size() for a in args) \
            + x.numel() * x.element_size()
        b_ms, b_by = cs.bound(n_bytes, ms.mamba_scan_flops(B, T, di, ds),
                              "float32")
        row = in_turns(torch, new, old, flush)
        row.update(warm_l2_ms=cs.graph_ms(torch, new),
                   bf16_x_ms=cs.graph_ms(torch, lambda: ms.mamba_scan(
                       xb, *args[1:]), flush),
                   bound_ms=b_ms, bound_by=b_by, max_diff_vs_baseline=diff)
        key = f"{B}x{T}x{di}x{ds}"
        rows[key] = row
        cs.log("timing", f"mamba_scan {key} float32: {json.dumps(row)}")
    return rows


# (payload, F) of the timed bell_spmm calls: layers 1 and 2 forward over
# bell, and their dX passes over bell_t
BELL_TIMED = {"bell F=16": (0, 16), "bell F=3": (0, 3),
              "bell_t F=16": (1, 16), "bell_t F=3": (1, 3)}


def check_bell(torch, dec) -> dict:
    """bell_spmm against its plain version; the largest errors."""
    from repro_torch.kernels import bell_spmm as bell_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = [(p.blocks, p.col_idx, p.n_valid, p.n_cols)
             for p in dec.sub("inter").formats["bell"]]
    cases += [cs.synthetic_bell(torch, gen, B, dev) for B in (8, 32, 64)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        tol = cs.F32_TOL if dtype == torch.float32 else cs.BF16_TOL
        for i, (blocks, ci, nv, n_cols) in enumerate(cases):
            blocks = blocks.to(dtype)
            rows = blocks.shape[0] * blocks.shape[2]
            for F in ((3, 16, 64, 500) if i < 2 else (1, 3, 16, 17, 65)):
                x = torch.randn((n_cols, F), generator=gen,
                                device=dev).to(dtype)
                y_in = torch.randn((rows, F), generator=gen,
                                   device=dev).to(dtype)
                for yi, nvi in ((None, nv), (y_in, nv), (None, None)):
                    got = bell_mod.bell_spmm(blocks, ci, x, yi, n_valid=nvi)
                    again = bell_mod.bell_spmm(blocks, ci, x, yi, n_valid=nvi)
                    want = bell_mod.plain(blocks, ci, x, yi)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise RuntimeError("bell_spmm gave other bits on a "
                                           "second call")
                    torch.testing.assert_close(got.float(), want.float(),
                                               **tol)
                    errs[key] = max(errs[key], cs.max_err(got, want))
                    n += 1
    cs.log("kernel", f"bell_spmm: {n} cases within tolerance, same bits "
           f"twice; largest errors {errs}")
    return errs


def time_bell(torch, dec, flush, base) -> dict:
    """bell_spmm at BELL_TIMED beside the BSR product and its bound (as
    chip_smoke.py's bell_spmm row), then the probe: L2 warm, and F = 64."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import bell_spmm as bell_mod
    gen = torch.Generator(device="cuda").manual_seed(8)
    payloads = dec.sub("inter").formats["bell"]
    bsrs = [cs.bsr_of(torch, p) for p in payloads]
    rows = {}

    def kernel_of(p, x):
        return lambda: bell_mod.bell_spmm(p.blocks, p.col_idx, x,
                                          n_valid=p.n_valid)

    def baseline_of(p, x):
        y = torch.empty((p.n_rows, x.shape[1]), device="cuda")
        nbr, K, B, _ = p.blocks.shape

        def run():
            base.launch(p.blocks.data_ptr(), p.col_idx.data_ptr(),
                       p.n_valid.data_ptr(), x.data_ptr(), None,
                       y.data_ptr(), nbr, K, B, x.shape[1], 0,
                       _build.stream(x))
            return y
        return run

    for key, (which, F) in BELL_TIMED.items():
        p, bsr = payloads[which], bsrs[which]
        x = torch.randn((p.n_cols, F), generator=gen, device="cuda")
        want = bell_mod.plain(p.blocks, p.col_idx, x)
        torch.testing.assert_close(kernel_of(p, x)(), want, **cs.F32_TOL)
        b_ms, b_by = cs.bell_spmm_bound(p, F)
        r = in_turns(torch, kernel_of(p, x), baseline_of(p, x)
                     if base is not None else None, flush)
        lib_ms = None
        if bsr is not None:
            torch.testing.assert_close(bsr @ x, want, **cs.F32_TOL)
            lib_ms = cs.yardstick_ms(torch, lambda: bsr @ x, flush,
                                     f"BSR @ x {key}")[0]
        r.update(library_ms=lib_ms,
                 library_call="torch.sparse_bsr_tensor(real blocks) @ x",
                 bound_ms=b_ms, bound_by=b_by,
                 real_blocks=int(p.n_valid.sum()))
        rows[key] = r
        cs.log("timing", f"bell_spmm {key}: {json.dumps(r)}")

    # the probe: L2 warm, and the gathered X grown with F
    p = payloads[0]
    probe = {}
    for name, F, fl in (("flushed", 16, flush), ("warm_l2", 16, None),
                        ("f_64", 64, flush), ("f_64_warm_l2", 64, None)):
        x = torch.randn((p.n_cols, F), generator=gen, device="cuda")
        torch.testing.assert_close(kernel_of(p, x)(), bell_mod.plain(
            p.blocks, p.col_idx, x), **cs.F32_TOL)
        probe[name] = cs.graph_ms(torch, kernel_of(p, x), fl)
        cs.log("probe", f"bell_spmm bell {name}: {probe[name]:.4f} ms")
    probe["f_64_bound_ms"] = cs.bell_spmm_bound(p, 64)[0]
    return {"rows": rows, "probe": probe}


def check_dw(torch, dec) -> dict:
    """tcgnn_spmm_dw against its plain version; the largest errors
    relative to max|dW|."""
    from repro_torch.kernels import tcgnn_tile as tc_mod
    dev = dec.device
    gen = torch.Generator(device=dev).manual_seed(9)
    tc_t = dec.sub("inter").formats["tcgnn_tile"][1]
    cases = [(tc_t.tiles, tc_t.gather_idx)] + [
        cs.synthetic_tcgnn(torch, gen, B, dev) for B in (8, 32, 64)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        for tiles, gi in cases:
            n = tiles.shape[0] * tiles.shape[1]
            for Fi, Fo in cs.WIDTHS + ((1100, 65),):
                x = torch.randn((n, Fi), generator=gen, device=dev).to(dtype)
                g = torch.randn((n, Fo), generator=gen, device=dev).to(dtype)
                got = tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)
                if not torch.equal(got, tc_mod.tcgnn_spmm_dw(tiles, gi, x, g)):
                    raise RuntimeError("tcgnn_spmm_dw gave other bits on a "
                                       "second call")
                rel = cs.dw_rel_err(got, tc_mod.plain_dw(tiles, gi, x, g),
                                    f"tcgnn_spmm_dw {key} {Fi}x{Fo}")
                errs[key] = max(errs[key], rel)
                n_cases += 1
    cs.log("kernel", f"tcgnn_spmm_dw: {n_cases} cases within 1e-5 of "
           f"max|dW|, same bits twice; largest / max|dW| {errs}")
    return errs


def baseline_dw_rows(root: Path) -> int:
    """DW_ROWS_PER_SPLIT of the checkout at ``root``, imported from its own
    module in a process of its own (the block rows a split that its
    tcgnn_spmm_dw wrapper passes to the kernel)."""
    code = ("from repro_torch.kernels import tcgnn_tile; "
            "print(tcgnn_tile.DW_ROWS_PER_SPLIT)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    return int(out.stdout.strip().splitlines()[-1])


def time_dw(torch, dec, flush, base, base_rows) -> dict:
    """tcgnn_spmm_dw at 500x16 and 16x3 beside x.T @ bmm(tiles_t,
    g[gather_idx_t]) and its bound (as chip_smoke.time_tcgnn_kernels), then
    the probe: L2 warm, Fi = 32 and 128."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import tcgnn_tile as tc_mod
    gen = torch.Generator(device="cuda").manual_seed(10)
    p = dec.sub("inter").formats["tcgnn_tile"][1]
    nbr, B, C = p.tiles.shape
    n = dec.n_pad
    gi = p.gather_idx.long()

    def baseline_of(x, g):
        Fi, Fo = x.shape[1], g.shape[1]
        part = torch.empty((-(-nbr // base_rows), Fi, Fo), device="cuda")
        dw = torch.empty((Fi, Fo), device="cuda")

        def run():
            base.launch(p.tiles.data_ptr(), p.gather_idx.data_ptr(),
                        x.data_ptr(), g.data_ptr(), part.data_ptr(),
                        dw.data_ptr(), nbr, B, C, Fi, Fo, base_rows, 0,
                        _build.stream(x))
            return dw
        return run

    rows = {}
    for Fi, Fo in cs.WIDTHS[:2]:
        key = f"{Fi}x{Fo}"
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        g = torch.randn((n, Fo), generator=gen, device="cuda")
        want = tc_mod.plain_dw(p.tiles, p.gather_idx, x, g)
        ref = lambda: x.T @ torch.bmm(p.tiles, g[gi]).view(n, Fo)  # noqa: E731
        cs.dw_rel_err(ref(), want, "x.T @ bmm(tiles_t, g[gather_idx_t])")
        new = lambda: tc_mod.tcgnn_spmm_dw(  # noqa: E731
            p.tiles, p.gather_idx, x, g)
        cs.dw_rel_err(new(), want, f"tcgnn_spmm_dw {key}")
        old = None
        if base is not None:
            old = baseline_of(x, g)
            cs.dw_rel_err(old(), want, f"baseline tcgnn_spmm_dw {key}")
        b_ms, b_by = cs.tcgnn_dw_bound(torch, p, n, Fi, Fo)
        r = in_turns(torch, new, old, flush)
        r.update(library_ms=cs.graph_ms(torch, ref, flush),
                 library_call="x.T @ torch.bmm(tiles_t, g[gather_idx_t])",
                 bound_ms=b_ms, bound_by=b_by,
                 real_slots=int(tc_mod.real_slots(p.tiles).sum()))
        rows[key] = r
        cs.log("timing", f"tcgnn_spmm_dw {key}: {json.dumps(r)}")

    probe = {}
    for name, Fi, fl in (("flushed", 500, flush), ("warm_l2", 500, None),
                         ("fi_32", 32, flush), ("fi_128", 128, flush)):
        x = torch.randn((n, Fi), generator=gen, device="cuda")
        g = torch.randn((n, 16), generator=gen, device="cuda")
        run = lambda: tc_mod.tcgnn_spmm_dw(  # noqa: E731
            p.tiles, p.gather_idx, x, g)
        cs.dw_rel_err(run(), tc_mod.plain_dw(p.tiles, p.gather_idx, x, g),
                      f"tcgnn_spmm_dw probe {name}")
        probe[name] = cs.graph_ms(torch, run, fl)
        cs.log("probe", f"tcgnn_spmm_dw {Fi}x16 {name}: "
               f"{probe[name]:.4f} ms")
    return {"rows": rows, "probe": probe}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(SOURCES),
                    help="comma-separated kernels to build, check and time "
                         f"(of {', '.join(SOURCES)})")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a checkout whose sources of these kernels are "
                         "timed in turns")
    args = ap.parse_args()
    names = tuple(k for k in args.kernels.split(",") if k)
    if not names or any(k not in SOURCES for k in names):
        ap.error(f"--kernels takes names of {SOURCES}, got {args.kernels}")
    import torch
    if not torch.cuda.is_available():
        print("port_kernels_bench: needs one CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as graph_mod
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all(names)
    for name in names:
        b = libs[name]
        cs.log("build", f"{name}: nvcc {b.seconds:.2f} s")
        for line in b.ptxas:
            cs.log("build", f"{name}: {line}")
    base = build_baseline(args.baseline, names) if args.baseline else {}
    dec = sdec = None
    if any(n in GATHER for n in names):
        graph = graph_mod.synth_dataset("pubmed", scale=1.0, seed=0)
        cfg = gnn.GNNConfig(model="gcn", hidden=16, n_layers=2,
                            comm_size=16, reorder="bfs", inter_buckets=1,
                            selector="fixed",
                            fixed_kernels=("block_diag", "bell"), seed=0)
        dec = gnn.prepare(graph, cfg, device="cuda")
        if "block_diag_spmm_dual" in names:
            sdec = gnn.prepare(graph, gnn.GNNConfig(model="sage",
                                                    selector="fixed"),
                               device="cuda")
    scratch = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    flush = scratch.zero_
    for _ in range(500):   # clocks up before the first timing
        flush()
    torch.cuda.synchronize()
    out = {"errors": {}}
    if "bell_spmm" in names:
        out["errors"]["bell_spmm"] = check_bell(torch, dec)
        out["bell_spmm"] = time_bell(torch, dec, flush, base.get("bell_spmm"))
    if "tcgnn_spmm_dw" in names:
        out["errors"]["tcgnn_spmm_dw"] = check_dw(torch, dec)
        out["tcgnn_spmm_dw"] = time_dw(
            torch, dec, flush, base.get("tcgnn_spmm_dw"),
            baseline_dw_rows(args.baseline) if args.baseline else None)
    if "tcgnn_spmm_fused" in names:
        out["errors"]["tcgnn_spmm_fused"] = check_tcgnn(torch, dec)
        out["tcgnn_spmm_fused"] = time_tcgnn(torch, dec, flush,
                                             base.get("tcgnn_spmm_fused"))
    if "tcgnn_spmm" in names:
        out["errors"]["tcgnn_spmm"] = check_tcgnn_spmm(torch, dec)
        out["tcgnn_spmm"] = time_tcgnn_spmm(torch, dec, flush,
                                            base.get("tcgnn_spmm"))
    if "block_diag_spmm_dual" in names:
        errs = {"block_diag_spmm_dual": {"float32": 0.0, "bfloat16": 0.0}}
        cs.phase_kernels_dual(torch, sdec, errs)
        out["errors"]["block_diag_spmm_dual"] = errs["block_diag_spmm_dual"]
        out["block_diag_spmm_dual"] = time_dual(
            torch, sdec, flush, base.get("block_diag_spmm_dual"))
    if "block_diag_spmm" in names:
        out["errors"]["block_diag_spmm"] = check_block_diag(torch, dec)
        out["block_diag_spmm"] = time_block_diag(
            torch, dec, flush, base.get("block_diag_spmm"))
    if "flash_attention" in names:
        errs = {"flash_attention": {"float32": 0.0, "bfloat16": 0.0}}
        cs.phase_kernels_flash(torch, errs)
        out["errors"]["flash_attention"] = errs["flash_attention"]
        out["flash_attention"] = time_flash(torch, flush,
                                            base.get("flash_attention"))
    for name, check, timer in (
            ("rwkv6_chunked", cs.phase_kernels_rwkv, time_rwkv),
            ("mamba_scan", cs.phase_kernels_mamba, time_mamba)):
        if name in names:
            errs = {name: {"float32": 0.0, "bfloat16": 0.0}}
            check(torch, errs)
            out["errors"][name] = errs[name]
            out[name] = timer(torch, flush, base.get(name))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
