"""Architecture registry: one module per assigned architecture.

Counterpart of ``repro/configs``.  ``get_config(name)`` returns the FULL
published config; ``get_config(name, reduced=True)`` the same-family
reduced config of the smoke tests.  The configs are copied verbatim from
the reference, all ten of ``ARCHS``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import ModelConfig

ARCHS = [
    "deepseek_moe_16b",
    "deepseek_v3_671b",
    "qwen2_5_14b",
    "codeqwen1_5_7b",
    "mistral_large_123b",
    "internlm2_1_8b",
    "jamba_v0_1_52b",
    "qwen2_vl_7b",
    "whisper_large_v3",
    "rwkv6_7b",
]
# assigned input-shape set (LM-family): seq_len x global_batch
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    name = canonical(name)
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.REDUCED if reduced else mod.FULL


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; returns (ok, reason_if_skipped).
    long_500k needs sub-quadratic sequence mixing."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention at 512k context is not "
                       "serviceable; skipped per assignment note")
    return True, ""
