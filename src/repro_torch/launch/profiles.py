"""Optimized execution profiles (counterpart of
``repro/launch/profiles.py``): the reference's launcher rules, what
``launch/dryrun.py --optimized`` applies.

``optimized_overrides(cfg, mode, mesh_model=16)`` returns
(model_overrides, rules_overrides):

  1. head padding to the tensor-parallel multiple when head counts are
     indivisible,
  2. the flash-attention kernel core for full-sequence attention,
  3. the selective-scan kernel core for Mamba layers and the chunked
     WKV-6 kernel core for RWKV-6,
  4. size-adaptive weight placement: ZeRO-1 (weights sharded over the
     model axis only, replicated over data) when the model-axis shard of
     the weights fits half of one device's memory and the model is not a
     hybrid (Jamba), otherwise FSDP over data as ``default_rules`` says.

The reference prices rule 4 against a constant 16 GiB device; here the
device's memory is ``hbm_bytes=``, by default what
``torch.cuda.get_device_properties`` reports for the current CUDA device.
No device constant is written into the port.
"""
from __future__ import annotations

import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.models.lm import ModelConfig

ZERO1_SAFETY = 0.5              # weights may use at most half of memory


def device_memory_bytes(device: str | torch.device = DEFAULT_DEVICE
                        ) -> int:
    """Total memory of ``device`` (a CUDA device), as its properties
    report it; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("device memory is read from a CUDA device, and "
                           "torch.cuda.is_available() is False: pass "
                           "hbm_bytes=")
    return int(torch.cuda.get_device_properties(
        torch.device(device)).total_memory)


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def padded_heads(cfg: ModelConfig, mesh_model: int) -> dict:
    out = {}
    if cfg.layer_pattern == "rwkv" or cfg.attn_type == "mla":
        return out    # rwkv: no attention; MLA: 128 heads already divide
    if cfg.n_heads % mesh_model:
        out["n_heads"] = _pad_to(cfg.n_heads, mesh_model)
    if cfg.kv_heads % mesh_model:
        kv = _pad_to(cfg.kv_heads, mesh_model)
        out["kv_heads"] = kv
        # GQA requires n_heads % kv_heads == 0
        nh = out.get("n_heads", cfg.n_heads)
        if nh % kv:
            out["n_heads"] = _pad_to(nh, kv)
    return out


def weights_fit_zero1(cfg: ModelConfig, mesh_model: int,
                      hbm_bytes: int | None = None) -> bool:
    """Whether 1/``mesh_model`` of the weights (their dtypes' bytes) fits
    in ``ZERO1_SAFETY`` of ``hbm_bytes`` (default: this card's memory)."""
    from repro_torch.launch import specs
    from repro_torch.tree import tree_leaves
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes()
    n_bytes = sum(a.numel() * a.element_size()
                  for a in tree_leaves(specs.params_shapes(cfg)))
    return n_bytes / mesh_model < hbm_bytes * ZERO1_SAFETY


def optimized_overrides(cfg: ModelConfig, mode: str, mesh_model: int = 16,
                        hbm_bytes: int | None = None
                        ) -> tuple[dict, dict | None]:
    model: dict = {}
    rules: dict | None = None
    model.update(padded_heads(cfg, mesh_model))
    if cfg.layer_pattern != "rwkv" and mode != "decode":
        model["attn_core"] = "flash"
    if cfg.layer_pattern == "jamba":
        model["mamba_core"] = "pallas"
    if cfg.layer_pattern == "rwkv":
        model["wkv_core"] = "pallas"
    hybrid = cfg.layer_pattern == "jamba"
    if not hybrid and weights_fit_zero1(cfg, mesh_model, hbm_bytes):
        rules = {"embed": None}      # ZeRO-1: weights on the model axis only
    return model, rules
