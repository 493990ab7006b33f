"""tcgnn_spmm_fused and the bf16 flash_attention path alone on the card.

Builds only ``csrc/tcgnn_spmm_fused.cu`` and ``csrc/flash_attention.cu``,
prepares the pubmed graph as ``chip_smoke.py`` does, and holds both kernels
against their plain versions: tcgnn_spmm_fused on pubmed's forward and
transpose payloads and on synthetic ones (B in 8, 32, 64), at the main
path's widths, float32 and bfloat16, y_in on and off; flash_attention at
``chip_smoke.phase_kernels_flash``'s cases and gates.  Then it times them
(CUDA graphs, L2 flushed) beside their library yardsticks and bounds:
tcgnn_spmm_fused at 500x16 and 16x3 on the forward payload and the dX pass
3x16 on the transpose payload, flash_attention bf16 causal at
``chip_smoke.FLASH_TIMED``.  A probe of what bounds tcgnn_spmm_fused at
500x16 follows: the same call with L2 warm, and with Fi cut to 32 and 128.

With ``--baseline DIR`` (a checkout of another commit) it also builds that
commit's two sources and times its kernels in turns with these (baseline,
this tree, this tree, baseline) on the same inputs.  Needs one CUDA card and
nvcc; from the root of a checkout:

    python3 tools/port_kernels_bench.py [--baseline DIR]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SOURCES = ("tcgnn_spmm_fused", "flash_attention")
# (payload, Fi, Fo) of the timed tcgnn_spmm_fused calls: layer 1, layer 2,
# and layer 2's dX pass over the transpose payload with W^T
TCGNN_TIMED = {"500x16": (0, 500, 16), "16x3": (0, 16, 3),
               "3x16 dX": (1, 3, 16)}


def build_baseline(root: Path) -> dict:
    """The two sources of the checkout at ``root``, built side by side with
    nvcc and loaded (``{name: _build.Built}``)."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        so = _build.BUILD_DIR / f"lib{name}-baseline.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        o, e = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the baseline {name}:\n{o}{e}")
        out[name] = _build._load(name, so, 0.0, ())
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a checkout whose two sources are timed in turns")
    args = ap.parse_args()
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
    libs = _build.build_all(SOURCES)
    for name, b in libs.items():
        cs.log("build", f"{name}: nvcc {b.seconds:.2f} s")
        for line in b.ptxas:
            cs.log("build", f"{name}: {line}")
    base = build_baseline(args.baseline) if args.baseline else {}
    graph = graph_mod.synth_dataset("pubmed", scale=1.0, seed=0)
    cfg = gnn.GNNConfig(model="gcn", hidden=16, n_layers=2, comm_size=16,
                        reorder="bfs", inter_buckets=1, selector="fixed",
                        fixed_kernels=("block_diag", "bell"), seed=0)
    dec = gnn.prepare(graph, cfg, device="cuda")
    errs = {"tcgnn_spmm_fused": check_tcgnn(torch, dec),
            "flash_attention": {"float32": 0.0, "bfloat16": 0.0}}
    cs.phase_kernels_flash(torch, errs)
    scratch = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    tcgnn = time_tcgnn(torch, dec, scratch.zero_,
                       base.get("tcgnn_spmm_fused"))
    flash = time_flash(torch, scratch.zero_, base.get("flash_attention"))
    print(json.dumps({"errors": errs, "tcgnn_spmm_fused": tcgnn,
                      "flash_attention": flash,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
