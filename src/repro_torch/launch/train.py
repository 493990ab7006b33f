"""End-to-end LM training: the reference's loop on one device.

Counterpart of ``repro/launch/train.py``: deterministic data
(``data/pipeline.py``), the train step (``train/steps.py``: AdamW, optional
gradient compression and accumulation), crash-safe checkpoints of
``(params, opt_state)`` every ``ckpt_every`` steps with resume from the
latest valid one (``distributed/checkpoint.py``), and straggler monitoring
(``distributed/fault_tolerance.py``).

The parameters and optimizer state are placed through their shardings
on a mesh (``use_mesh``, by default ``launch/mesh.host_local_mesh`` of
``device``): ``sharding.tree_shardings`` of ``lm.param_specs`` under
``default_rules``, as the reference places them.  The port's meshes
place on one device (``launch/mesh.py``), so the losses are those of the
same run without a mesh.  A resume restores the checkpoint onto the
mesh's shardings (``CheckpointManager.restore(shardings=)``): the
elastic re-mesh of ``distributed/elastic.py`` is ``plan_rescale``, a
``mesh.make_mesh`` of its shape, and a resumed ``train(use_mesh=...)``
with its global batch.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 50 --seq 64 --batch 8 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 4 \\
        --seq 4096 --batch 2 --accum 2        # InternLM2-1.8B on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2_vl_7b        # embeds and (3, B, S) M-RoPE positions
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch whisper_large_v3   # encoder frames and decoder tokens

Every architecture takes its batches from ``data.pipeline_for``: tokens,
Qwen2-VL's stub patch embeddings with text positions on all three M-RoPE
streams, or Whisper's stub encoder frames (``encoder_seq`` of them) and
decoder tokens.

``--full`` trains the published config, whose default cores are the plain
ones; ``train(overrides=...)`` sets config fields such as
``attn_core="flash"`` (the flash kernel) or ``mamba_core="pallas"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import DEFAULT_DEVICE, configs, resolve_device
from repro_torch.data import pipeline as data_mod
from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.distributed import compression
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod
from repro_torch.tree import tree_leaves


def train(arch: str, *, reduced: bool = True, steps: int = 20, seq: int = 64,
          global_batch: int = 8, lr: float = 3e-4, accum: int = 1,
          ckpt_dir: str | None = None, ckpt_every: int = 10,
          grad_compression: str = "none", seed: int = 0,
          device: str | torch.device = DEFAULT_DEVICE,
          overrides: dict | None = None, use_mesh=None,
          verbose: bool = True) -> dict:
    """Trains ``arch`` (config fields replaced by ``overrides``) for
    ``steps`` steps from parameters drawn on ``device`` from ``seed`` and
    placed on ``use_mesh`` (default: ``host_local_mesh(device)``), on the
    mesh's device; with ``ckpt_dir`` resumes from its latest valid
    checkpoint, restored onto the mesh's shardings, and saves every
    ``ckpt_every`` steps.  Returns the losses of the steps run, the final
    loss, the params and the stragglers."""
    dev = resolve_device(device)
    cfg = configs.get_config(arch, reduced=reduced)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = use_mesh if use_mesh is not None else mesh_mod.host_local_mesh(dev)
    rules = sharding.default_rules(mesh)

    pipe = data_mod.pipeline_for(cfg, seq, global_batch, seed=seed)
    opt_cfg = adamw.OptConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                              total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, accum_steps=accum,
                                        grad_compression=grad_compression)

    params = lm.init_params(lm.make_generator(seed, dev), cfg)
    logical = lm.param_specs(cfg)
    pshard = sharding.tree_shardings(params, logical, mesh, rules)
    params = sharding.place_tree(params, pshard)
    run_dev = tree_leaves(params)[0].device
    opt_state = adamw.init_state(params)
    opt_logical = adamw.state_specs(logical)
    if grad_compression == "topk_ef":
        opt_state["ef"] = compression.init_error_feedback(params)
        opt_logical["ef"] = logical

    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(ckpt_dir)
        latest = mgr.latest_valid_step()
        if latest is not None:
            oshard = sharding.tree_shardings(opt_state, opt_logical, mesh,
                                             rules)
            (params, opt_state), start_step = mgr.restore(
                (params, opt_state), latest, shardings=(pshard, oshard))
            if verbose:
                print(f"restored checkpoint at step {start_step} onto "
                      f"{mesh}")

    monitor = ft.StragglerDetector()
    losses = []
    try:
        for i in range(start_step, steps):
            batch = {k: torch.from_numpy(v).to(run_dev)
                     for k, v in pipe.batch(i).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))   # waits for the device
            monitor.observe(host=0, step_seconds=time.perf_counter() - t0)
            if verbose and (i % max(steps // 10, 1) == 0 or i == steps - 1):
                print(f"step {i:5d} loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e}")
            if mgr and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, (params, opt_state))
    finally:
        if mgr:
            mgr.wait()      # a crash still lands the last save
    return dict(losses=losses, final_loss=losses[-1] if losses else None,
                params=params, stragglers=monitor.stragglers())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the FULL published config (default: REDUCED)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args()
    res = train(args.arch, reduced=args.reduced, steps=args.steps,
                seq=args.seq, global_batch=args.batch, lr=args.lr,
                accum=args.accum, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                grad_compression=args.grad_compression, device=args.device)
    print(f"final loss: {res['final_loss']:.4f}")


if __name__ == "__main__":
    main()
