"""Batched LM serving on the port: prefill a batch of prompts, then
greedy-decode continuations (counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --full \\
        --prompt-len 1024 --gen 32        # InternLM2-1.8B at full size
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch rwkv6_7b \\
        --full --wkv-core pallas --prompt-len 1024 --gen 32   # RWKV6-7B

The prefill is the cache-producing ``lm.prefill``, as in the reference:
plain attention, and for RWKV-6 the sequential recurrence under the
kernel core (``wkv_core="pallas"``, the reference's serving profile) or
the plain chunked form under ``"xla"``.  The config's default core is
``"xla"``; at RWKV6-7B's published chunk 128 its chunked form overflows
float32 in both packages (ROADMAP section 3 fault 7), so serve it with
``--wkv-core pallas``.  The hand kernels run in ``make_prefill_step``:
flash attention under ``attn_core="flash"`` and the RWKV-6 kernel under
``wkv_core="pallas"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.train import steps as steps_mod


def serve_lm(arch: str, *, reduced: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 16, seed: int = 0,
             device: str | torch.device = DEFAULT_DEVICE,
             overrides: dict | None = None, verbose: bool = True) -> dict:
    """Prompts from ``numpy.random.default_rng(seed)``, parameters from a
    generator seeded with ``seed`` on ``device``; ``overrides`` replaces
    config fields (``dataclasses.replace``), e.g. ``wkv_core``.  Returns
    the generated tokens (batch, gen) as numpy int32, the wall seconds
    (prefill and decode, the kernels' first-use build included) and
    tokens/s."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(configs.get_config(arch, reduced=reduced),
                              **(overrides or {}))
    assert cfg.input_mode == "tokens" and cfg.family == "decoder", \
        "serving demo drives token-mode decoder archs"
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    ).to(dev)

    params = lm.init_params(lm.make_generator(seed, dev), cfg)
    s_max = prompt_len + gen
    serve_step = steps_mod.make_serve_step(cfg)

    toks = []
    t0 = time.perf_counter()
    with torch.no_grad():
        # one-shot cache-producing prefill, then token-by-token decode
        logits, caches = lm.prefill(params, cfg, dict(tokens=prompts), s_max)
        nxt = torch.argmax(logits[:, -1:, : cfg.vocab],
                           dim=-1).to(torch.int32)
        for t in range(prompt_len, s_max):
            toks.append(nxt)
            nxt, logits, caches = serve_step(params, caches, nxt, t)
    out = torch.cat(toks, dim=1).cpu().numpy()      # waits for the device
    dt = time.perf_counter() - t0
    tput = batch * (prompt_len + gen) / dt
    if verbose:
        print(f"{arch}: generated {out.shape} in {dt:.2f}s "
              f"({tput:.1f} tok/s on {dev})")
    return dict(tokens=out, seconds=dt, tokens_per_s=tput)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--full", action="store_true",
                    help="the FULL published config (default: REDUCED)")
    ap.add_argument("--wkv-core", choices=("xla", "pallas"),
                    help="RWKV-6's recurrence core (default: the config's, "
                         "xla); pallas is the reference's serving profile")
    args = ap.parse_args()
    out = serve_lm(args.arch, reduced=not args.full, batch=args.batch,
                   prompt_len=args.prompt_len, gen=args.gen,
                   device=args.device,
                   overrides=(dict(wkv_core=args.wkv_core)
                              if args.wkv_core else None))
    print("generated token ids:\n", out["tokens"])


if __name__ == "__main__":
    main()
