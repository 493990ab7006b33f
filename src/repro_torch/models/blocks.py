"""Transformer building blocks: GQA attention and the dense FFN.

Counterpart of ``repro/models/blocks.py`` for the blocks of the ported LM
slice.  Every block provides ``init_X(gen, ...)`` (params as a dict of
tensors on the generator's device), ``X_apply(params, x, ...)`` (full
sequence) and, where relevant, ``X_decode(params, x, cache, pos)``.  MLA,
MoE, Mamba and RWKV-6 come with the models that use them (ROADMAP section
1 item 8).

Matmul-heavy math runs in the model dtype with float32 accumulation;
softmax and norm statistics run in float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref
from repro_torch.layers import nn, rope as rope_mod

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _dense(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return nn.lecun_normal(gen, shape).to(dtype)


def einsum(s: str, *xs: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: products sum in
    float32.  Float32 operands give float32.  With bfloat16 operands torch
    rounds the float32 sums to bfloat16 on output, which is where every
    caller of the reference casts them (``.astype(x.dtype)``) anyway."""
    return torch.einsum(s, *xs)


# ---------------------------------------------------------------------------
# Attention (MHA / GQA, optional QKV bias)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple | None = None   # qwen2-vl
    causal: bool = True
    use_rope: bool = True
    # "softmax": plain attention (ref.mha); "flash": the flash kernel for
    # causal self-attention with S % 128 == 0 (else softmax); "identity":
    # the zero-cost stand-in of the reference's attention-core probes
    attn_core: str = "softmax"


def init_attention(gen: torch.Generator, cfg: AttnConfig,
                   dtype: torch.dtype = torch.float32) -> dict:
    H, KV, dh, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    p = dict(
        wq=_dense(gen, (d, H * dh), dtype),
        wk=_dense(gen, (d, KV * dh), dtype),
        wv=_dense(gen, (d, KV * dh), dtype),
        wo=_dense(gen, (H * dh, d), dtype),
    )
    if cfg.qkv_bias:
        for name, n in (("bq", H * dh), ("bk", KV * dh), ("bv", KV * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _qkv(params, cfg: AttnConfig, x, positions):
    B, S, _ = x.shape
    q = einsum("bsd,dh->bsh", x, params["wq"]).to(x.dtype)
    k = einsum("bsd,dh->bsh", x, params["wk"]).to(x.dtype)
    v = einsum("bsd,dh->bsh", x, params["wv"]).to(x.dtype)
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.kv_heads, cfg.head_dim)
    if cfg.use_rope:
        if cfg.mrope_sections is not None:
            raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet: "
                                      "ROADMAP section 1 item 8")
        q = rope_mod.apply_rope(q, positions, cfg.rope_theta)
        k = rope_mod.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(params, cfg: AttnConfig, x, positions):
    """Full-sequence self-attention. positions: (B, S).  (Whisper's
    cross-attention override comes with that model.)"""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    if cfg.attn_core == "identity":
        g = cfg.n_heads // cfg.kv_heads
        vm = torch.mean(v, dim=1, keepdim=True)          # (B,1,Hkv,dh)
        out = vm.repeat_interleave(g, dim=2).expand(
            B, S, cfg.n_heads, v.shape[-1])
        out = out.reshape(B, S, -1)
    elif cfg.attn_core == "flash" and cfg.causal and S % 128 == 0:
        from repro_torch.kernels.flash_attention import \
            flash_attention_trainable
        out = flash_attention_trainable(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True)
        out = out.transpose(1, 2).reshape(B, S, -1)
    else:
        out = kref.mha(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=cfg.causal)
        out = out.transpose(1, 2).reshape(B, S, -1)
    return einsum("bsh,hd->bsd", out, params["wo"]).to(x.dtype)


def attention_decode(params, cfg: AttnConfig, x, cache, pos: int):
    """Single-step decode. x: (B, 1, d); cache: {k, v: (B, Smax, KV, dh)};
    pos: int, the new token's position.  The new k and v are written into
    ``cache`` in place at ``pos`` (the reference returns updated copies);
    returns (y, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    cache["k"][:, pos:pos + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v_new.to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    Smax = k.shape[1]
    mask = (torch.arange(Smax, device=x.device) <= pos)[None, None, None,
                                                        None, :]
    qh = q.transpose(1, 2)                                    # (B,H,1,dh)
    kh = k.transpose(1, 2).to(x.dtype)
    vh = v.transpose(1, 2).to(x.dtype)
    H, KV = cfg.n_heads, cfg.kv_heads
    g = H // KV
    qg = qh.reshape(B, KV, g, 1, cfg.head_dim)
    logits = einsum("bhgqd,bhtd->bhgqt", qg.float(),
                    kh.float()) * (cfg.head_dim ** -0.5)
    logits = logits.masked_fill(~mask, kref.NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = einsum("bhgqt,bhtd->bhgqd", p, vh.float())
    out = out.reshape(B, H, 1, cfg.head_dim).transpose(1, 2)
    out = out.reshape(B, 1, H * cfg.head_dim).to(x.dtype)
    y = einsum("bsh,hd->bsd", out, params["wo"]).to(x.dtype)
    return y, cache


def init_attn_cache(cfg: AttnConfig, batch: int, s_max: int,
                    dtype: torch.dtype, device: torch.device) -> dict:
    shp = (batch, s_max, cfg.kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shp, dtype=dtype, device=device),
                v=torch.zeros(shp, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Dense FFN: gated SiLU (whisper's ungated GELU comes with that model)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> dict:
    return dict(w_up=_dense(gen, (d_model, d_ff), dtype),
                w_down=_dense(gen, (d_ff, d_model), dtype),
                w_gate=_dense(gen, (d_model, d_ff), dtype))


def mlp_apply(params, x):
    up = einsum("bsd,df->bsf", x, params["w_up"]).to(x.dtype)
    gate = einsum("bsd,df->bsf", x, params["w_gate"]).to(x.dtype)
    h = F.silu(gate) * up
    return einsum("bsf,fd->bsd", h, params["w_down"]).to(x.dtype)
