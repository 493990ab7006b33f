"""Meta-tensor stand-ins for every model input (counterpart of
``repro/launch/specs.py``'s ``ShapeDtypeStruct``s): shapes and dtypes on
the ``meta`` device, no allocation, what the dry-run
(``launch/dryrun.py``) traces against and ``launch/sharding.py``
resolves.  Token ids and positions are int32 and the decode position a
0-d int32, as in the reference; float leaves take ``cfg``'s dtype
(float32 where the reference keeps float32)."""
from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.weights import lm_meta_params

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: lm.ModelConfig, seq: int, batch: int) -> dict:
    dt = cfg.torch_dtype
    out = {}
    if cfg.family == "encdec":
        out["enc_embeds"] = _meta((batch, cfg.encoder_seq, cfg.d_model), dt)
        out["tokens"] = _meta((batch, seq), torch.int32)
    elif cfg.input_mode == "embeds":
        out["embeds"] = _meta((batch, seq, cfg.d_model), dt)
        if cfg.mrope_sections is not None:
            out["positions"] = _meta((3, batch, seq), torch.int32)
    else:
        out["tokens"] = _meta((batch, seq), torch.int32)
    out["labels"] = _meta((batch, seq), torch.int32)
    return out


def prefill_batch_specs(cfg: lm.ModelConfig, seq: int, batch: int) -> dict:
    out = train_batch_specs(cfg, seq, batch)
    out.pop("labels")
    return out


def decode_specs(cfg: lm.ModelConfig, s_max: int, batch: int):
    """(caches, tokens, pos) for ``make_serve_step``: the caches of
    ``lm.init_cache`` on the meta device, the new token (ids (B, 1), or
    embeds (B, 1, d)) and the position, a 0-d int32 (the port's decode
    step takes it as a Python int: the dry-run passes ``s_max - 1``)."""
    caches = lm.init_cache(cfg, batch, s_max, device=META)
    if cfg.input_mode == "embeds":
        tokens = _meta((batch, 1, cfg.d_model), cfg.torch_dtype)
    else:
        tokens = _meta((batch, 1), torch.int32)
    return caches, tokens, _meta((), torch.int32)


def params_shapes(cfg: lm.ModelConfig) -> dict:
    return lm_meta_params(cfg)


def opt_state_shapes(cfg: lm.ModelConfig) -> dict:
    return adamw.init_state(params_shapes(cfg))


def input_specs(arch: str, shape_name: str) -> dict:
    """Everything the dry-run needs for one (arch, shape) cell."""
    cfg = configs.get_config(arch)
    sh = configs.SHAPES[shape_name]
    mode = sh["mode"]
    out = dict(cfg=cfg, mode=mode, seq=sh["seq"], batch=sh["batch"])
    if mode == "train":
        out["batch_specs"] = train_batch_specs(cfg, sh["seq"], sh["batch"])
    elif mode == "prefill":
        out["batch_specs"] = prefill_batch_specs(cfg, sh["seq"], sh["batch"])
    else:
        caches, tokens, pos = decode_specs(cfg, sh["seq"], sh["batch"])
        out.update(cache_specs=caches, token_specs=tokens, pos_specs=pos)
    return out
