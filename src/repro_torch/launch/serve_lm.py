"""Batched LM serving on the port: prefill a batch of prompts, then
greedy-decode continuations (counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --full \\
        --prompt-len 1024 --gen 32        # InternLM2-1.8B at full size
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch rwkv6_7b \\
        --full --prompt-len 1024 --gen 32                   # RWKV6-7B
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch jamba_v0_1_52b --full --layers 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch deepseek_moe_16b --full --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch deepseek_v3_671b --full --layers 4 --prompt-len 1024 --gen 32

Each family is served under the reference's serving profile for a
prefill (``repro/launch/profiles.py``, ``optimized_overrides``): the
flash core ``attn_core="flash"`` for every family with attention (all but
RWKV-6), and the kernel core of the recurrent layers, ``mamba_core=
"pallas"`` for Jamba and ``wkv_core="pallas"`` for RWKV-6 (whose config
default, the ``"xla"`` chunked form, overflows float32 at RWKV6-7B's
published chunk 128 in both packages: ROADMAP section 3 fault 7);
``overrides`` replaces any of it.  The prefill is the cache-producing
``lm.prefill``, as in the reference.  Of the attention layers only MLA's
(DeepSeek-V3) launch the flash kernel there, where the prompt length is
a multiple of 128; GQA attention (InternLM2, Qwen2.5, CodeQwen,
Mistral-Large, DeepSeekMoE, Jamba's attention layer) is plain ``ref.mha``
in the cache prefill whatever the core.  RWKV-6's recurrence is sequential
under its kernel core, and Jamba's Mamba layers run the ``mamba_scan``
kernel with the final state from the plain scan.  Decode runs no hand
kernel.  Jamba-v0.1 is 32 layers, 106 GB of bf16 weights: on one 80 GB
card serve one period, ``overrides=dict(n_layers=8)`` (``--layers 8``,
26.6 GB); DeepSeekMoE-16B fits whole (32.7 GB); DeepSeek-V3 at 4 layers,
its 3 dense MLA layers and one MoE layer (``--layers 4``, 31.6 GB).
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


def serving_profile(cfg: lm.ModelConfig) -> dict:
    """The reference's serving profile for ``cfg``'s family (its
    ``optimized_overrides`` outside decode): the flash core for every
    family with attention, and the kernel core of the recurrent
    layers."""
    if cfg.layer_pattern == "rwkv":
        return dict(wkv_core="pallas")
    if cfg.layer_pattern == "jamba":
        return dict(attn_core="flash", mamba_core="pallas")
    return dict(attn_core="flash")


def serve_lm(arch: str, *, reduced: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 16, seed: int = 0,
             device: str | torch.device = DEFAULT_DEVICE,
             overrides: dict | None = None, verbose: bool = True) -> dict:
    """Prompts from ``numpy.random.default_rng(seed)``, parameters from a
    generator seeded with ``seed`` on ``device``; the config takes the
    family's ``serving_profile``, then ``overrides`` (config fields, as
    ``dataclasses.replace`` takes them, e.g. ``n_layers``).  Returns
    the generated tokens (batch, gen) as numpy int32, the wall seconds
    (prefill and decode, the kernels' first-use build included) and
    tokens/s."""
    dev = resolve_device(device)
    cfg = configs.get_config(arch, reduced=reduced)
    cfg = dataclasses.replace(cfg, **{**serving_profile(cfg),
                                      **(overrides or {})})
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
    ap.add_argument("--layers", type=int,
                    help="cut the config's depth to this many layers")
    args = ap.parse_args()
    out = serve_lm(args.arch, reduced=not args.full, batch=args.batch,
                   prompt_len=args.prompt_len, gen=args.gen,
                   device=args.device,
                   overrides=(dict(n_layers=args.layers)
                              if args.layers else None))
    print("generated token ids:\n", out["tokens"])


if __name__ == "__main__":
    main()
