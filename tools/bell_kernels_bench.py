"""The fused blocked-ELL kernels alone on the card: bell_spmm_fused,
block_diag_spmm_fused (bell_spmm_fused.cu at K = 1) and bell_spmm_dw.

Builds the port's kernels, prepares the pubmed graph as ``chip_smoke.py``
does, holds the three kernels against their plain versions on the main
path's payloads and on synthetic ones (``chip_smoke.phase_kernels_train``:
float32 and bfloat16, (Fi, Fo) in {(500, 16), (16, 3), (3, 16)}, dW the
same bits twice), then times them at layer 1's and layer 2's widths beside
their plain versions, their library yardsticks and their bounds
(``chip_smoke.time_train_kernels``: CUDA graphs, L2 flushed).  Then it
probes what bounds bell_spmm_fused at layer 1's width: the same call with
L2 warm, with every stored block's source column taken mod 128 (the
gathered rows confined to 4 MB, resident in L2), and with Fi cut to 32 and
128 (the gathered bytes cut with it).  A quicker loop than
``chip_smoke.py`` for work on these two sources; needs one CUDA card and
nvcc.  From the root of a checkout:

    python3 tools/bell_kernels_bench.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def fused_probe(torch, dec, flush) -> dict:
    """bell_spmm_fused at (500, 16) on the main path's payload as timed in
    chip_smoke (L2 flushed), with L2 warm, with source columns mod 128, and
    at Fi = 32 and 128, each checked against its plain version."""
    from repro_torch.kernels import bell_spmm_fused as bellf_mod
    bell = dec.sub("inter").formats["bell"][0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((dec.n_pad, 500), generator=gen, device="cuda")
    w = torch.randn((500, 16), generator=gen, device="cuda") / 500 ** 0.5
    near = (bell.col_idx % 128).to(torch.int32)
    cases = {"flushed": (bell.col_idx, x, w, flush),
             "warm_l2": (bell.col_idx, x, w, None),
             "cols_mod_128": (near, x, w, flush)}
    for fi in (32, 128):
        cases[f"fi_{fi}"] = (bell.col_idx, x[:, :fi].contiguous(),
                             w[:fi].contiguous(), flush)
    out = {}
    for name, (ci, xx, ww, fl) in cases.items():
        def call(ci=ci, xx=xx, ww=ww):
            return bellf_mod.bell_spmm_fused(bell.blocks, ci, xx, ww,
                                             n_valid=bell.n_valid)
        torch.testing.assert_close(call(), bellf_mod.plain(
            bell.blocks, ci, xx, ww), **cs.F32_TOL)
        out[name] = cs.graph_ms(torch, call, fl)
        cs.log("probe", f"bell_spmm_fused {name}: {out[name]:.4f} ms")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bell_kernels_bench: needs one CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from repro_torch.core import gnn
    from repro_torch.graphs import graph as graph_mod
    t0 = time.perf_counter()
    cs.phase_build(torch)
    graph = graph_mod.synth_dataset("pubmed", scale=1.0, seed=0)
    cfg = gnn.GNNConfig(model="gcn", hidden=16, n_layers=2, comm_size=16,
                        reorder="bfs", inter_buckets=1, selector="fixed",
                        fixed_kernels=("block_diag", "bell"), seed=0)
    dec = gnn.prepare(graph, cfg, device="cuda")
    names = ("block_diag_spmm", "block_diag_spmm_fused", "bell_spmm_fused",
             "bell_spmm_dw")
    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    cs.phase_kernels_train(torch, dec, errs)
    scratch = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    bell, bell_t = dec.sub("inter").formats["bell"]
    rows = cs.time_train_kernels(torch, dec, scratch.zero_,
                                 cs.bsr_of(torch, bell),
                                 cs.bsr_of(torch, bell_t))
    probe = fused_probe(torch, dec, scratch.zero_)
    print(json.dumps({"errors": errs, "rows": rows, "fused_probe": probe,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
