"""Transformer building blocks: GQA attention, MLA (DeepSeek's multi-head
latent attention), the dense FFN, the MoE FFN (DeepSeek-style: shared
experts and routed top-k, dense or capacity dispatch), Mamba (selective
SSM), and RWKV-6's time-mix and channel-mix.

Counterpart of ``repro/models/blocks.py``.  Every block provides
``init_X(gen, ...)`` (params as a dict of tensors on the generator's
device), ``spec_X(cfg)`` (the same dict of each leaf's logical axes, a
tuple of names or None per dim, which ``launch/sharding.py`` resolves to
mesh axes), ``X_apply(params, x, ...)`` (full sequence) and, where
relevant, ``X_decode(params, x, cache, pos)`` with ``spec_X_cache``.
Attention takes RoPE or M-RoPE (Qwen2-VL) and whisper's cross-attention
(``kv_override``); the dense FFN is gated SiLU or whisper's ungated
GELU.

Matmul-heavy math runs in the model dtype with float32 accumulation;
softmax and norm statistics run in float32.
"""
from __future__ import annotations

import math
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


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched over the leading (expert) axis, (E, n, k) x (E,
    k, m) -> (E, n, m), with float32 sums and a float32 result from
    operands of any dtype: the reference's ``einsum`` where it keeps the
    float32 sums (no cast back to the model dtype).  On CUDA one cuBLAS
    product with a float32 output (``out_dtype``); on the CPU, where that
    overload has no kernel, one expert at a time on float32 copies (a
    product of two bfloat16 values is exact in float32).  Neither makes a
    float32 copy of the whole of ``b``."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.stack([a[e].float() @ b[e].float()
                        for e in range(b.shape[0])])


# ---------------------------------------------------------------------------
# Attention (MHA / GQA, optional QKV bias, optional M-RoPE)
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


def spec_attention(cfg: AttnConfig) -> dict:
    """Logical axes of ``init_attention``'s leaves (``launch/sharding.py``
    resolves them to mesh axes)."""
    s = dict(wq=("embed", "qkv"), wk=("embed", "kv"), wv=("embed", "kv"),
             wo=("qkv", "embed"))
    if cfg.qkv_bias:
        s.update(bq=("qkv",), bk=("kv",), bv=("kv",))
    return s


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
            q = rope_mod.apply_mrope(q, positions, cfg.mrope_sections,
                                     cfg.rope_theta)
            k = rope_mod.apply_mrope(k, positions, cfg.mrope_sections,
                                     cfg.rope_theta)
        else:
            q = rope_mod.apply_rope(q, positions, cfg.rope_theta)
            k = rope_mod.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(params, cfg: AttnConfig, x, positions,
                    kv_override=None):
    """Full-sequence attention. positions: (B, S), or (3, B, S) under
    M-RoPE.  kv_override: (k, v), each (B, Skv, KV, dh), replacing the
    projected k and v (whisper's cross-attention); q is still projected
    (and rotated) from ``x``.  The flash kernel runs only for causal
    self-attention with S % 128 == 0, as in the reference."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    if kv_override is not None:
        k, v = kv_override
    if cfg.attn_core == "identity":
        g = cfg.n_heads // cfg.kv_heads
        vm = torch.mean(v, dim=1, keepdim=True)          # (B,1,Hkv,dh)
        out = vm.repeat_interleave(g, dim=2).expand(
            B, S, cfg.n_heads, v.shape[-1])
        out = out.reshape(B, S, -1)
    elif (cfg.attn_core == "flash" and cfg.causal and kv_override is None
          and S % 128 == 0):
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
    pos: int, the new token's position (under M-RoPE on all three
    streams, as in the reference).  The new k and v are written into
    ``cache`` in place at ``pos`` (the reference returns updated copies);
    returns (y, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
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


def spec_attn_cache(cfg: AttnConfig) -> dict:
    return dict(k=("batch", "kv_seq", "kv", None),
                v=("batch", "kv_seq", "kv", None))


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 1e4
    attn_core: str = "softmax"    # see AttnConfig.attn_core

    @property
    def qk_dim(self):
        return self.qk_nope_dim + self.qk_rope_dim


def init_mla(gen: torch.Generator, cfg: MLAConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    H, dev = cfg.n_heads, gen.device
    return dict(
        wq_a=_dense(gen, (cfg.d_model, cfg.q_lora_rank), dtype),
        q_norm=torch.ones((cfg.q_lora_rank,), dtype=dtype, device=dev),
        wq_b=_dense(gen, (cfg.q_lora_rank, H * cfg.qk_dim), dtype),
        wkv_a=_dense(gen, (cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
                     dtype),
        kv_norm=torch.ones((cfg.kv_lora_rank,), dtype=dtype, device=dev),
        wkv_b=_dense(gen, (cfg.kv_lora_rank,
                           H * (cfg.qk_nope_dim + cfg.v_dim)), dtype),
        wo=_dense(gen, (H * cfg.v_dim, cfg.d_model), dtype),
    )


def spec_mla(cfg: MLAConfig) -> dict:
    return dict(wq_a=("embed", None), q_norm=(None,), wq_b=(None, "qkv"),
                wkv_a=("embed", None), kv_norm=(None,), wkv_b=(None, "qkv"),
                wo=("qkv", "embed"))


def _mla_qkv(params, cfg: MLAConfig, x, positions):
    """The query halves q_nope (B, S, H, nope) and q_rope (B, S, H, rope),
    the normed latent c_kv (B, S, kv_lora_rank) and the shared rotary key
    k_rope (B, S, 1, rope)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = nn.rms_norm(einsum("bsd,dr->bsr", x, params["wq_a"]).to(x.dtype),
                     params["q_norm"])
    q = einsum("bsr,rh->bsh", cq, params["wq_b"]).to(x.dtype)
    q = q.reshape(B, S, H, cfg.qk_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                 dim=-1)
    q_rope = rope_mod.apply_rope(q_rope, positions, cfg.rope_theta)
    kv = einsum("bsd,dr->bsr", x, params["wkv_a"]).to(x.dtype)
    c_kv, k_rope = torch.split(kv, [cfg.kv_lora_rank, cfg.qk_rope_dim],
                               dim=-1)
    c_kv = nn.rms_norm(c_kv, params["kv_norm"])
    k_rope = rope_mod.apply_rope(k_rope[:, :, None, :], positions,
                                 cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(params, cfg: MLAConfig, c_kv):
    """The latent cache expanded to per-head k_nope (B, S, H, nope) and v
    (B, S, H, v_dim) by ``wkv_b`` (the paper's form; the absorbed decode
    folds ``wkv_b`` into the query and the output instead)."""
    B, S, _ = c_kv.shape
    kv = einsum("bsr,rh->bsh", c_kv, params["wkv_b"]).to(c_kv.dtype)
    kv = kv.reshape(B, S, cfg.n_heads, cfg.qk_nope_dim + cfg.v_dim)
    return torch.split(kv, [cfg.qk_nope_dim, cfg.v_dim], dim=-1)


def _mla_attend(params, cfg: MLAConfig, x, q_nope, q_rope, c_kv, k_rope):
    """Causal attention of ``_mla_qkv``'s outputs over the expanded latent
    and the output projection, by ``cfg.attn_core``: "flash" is the flash
    kernel where S % 128 == 0 (q = [q_nope; q_rope] and k = [k_nope;
    k_rope on every head], d = qk_dim, dv = v_dim), else plain
    ``ref.mha``; "identity" the reference's zero-cost stand-in."""
    B, S, _ = x.shape
    H = cfg.n_heads
    k_nope, v = _mla_expand_kv(params, cfg, c_kv)
    if cfg.attn_core == "identity":
        out = torch.mean(v, dim=1, keepdim=True).expand(B, S, H, cfg.v_dim)
    else:
        q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_dim)],
                      dim=-1).transpose(1, 2)
        v = v.transpose(1, 2)
        scale = cfg.qk_dim ** -0.5
        if cfg.attn_core == "flash" and S % 128 == 0:
            from repro_torch.kernels.flash_attention import \
                flash_attention_trainable
            out = flash_attention_trainable(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                scale=scale)
        else:
            out = kref.mha(q, k, v, causal=True, scale=scale)
        out = out.transpose(1, 2)
    out = out.reshape(B, S, H * cfg.v_dim)
    return einsum("bsh,hd->bsd", out, params["wo"]).to(x.dtype)


def mla_apply(params, cfg: MLAConfig, x, positions):
    """Full-sequence causal MLA self-attention. positions: (B, S)."""
    return _mla_attend(params, cfg, x, *_mla_qkv(params, cfg, x, positions))


def init_mla_cache(cfg: MLAConfig, batch: int, s_max: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    return dict(c_kv=torch.zeros((batch, s_max, cfg.kv_lora_rank),
                                 dtype=dtype, device=device),
                k_rope=torch.zeros((batch, s_max, cfg.qk_rope_dim),
                                   dtype=dtype, device=device))


def spec_mla_cache(cfg: MLAConfig) -> dict:
    return dict(c_kv=("batch", "kv_seq", None),
                k_rope=("batch", "kv_seq", None))


def mla_decode(params, cfg: MLAConfig, x, cache, pos: int,
               absorbed: bool = False):
    """Single-step MLA decode against the latent cache {c_kv (B, Smax,
    kv_lora_rank), k_rope (B, Smax, rope)}, in float32 as the reference's
    einsums: ``absorbed`` folds ``wkv_b`` into the query (scores against
    c_kv directly) and the output, else the cache is expanded per head.
    The new c_kv and k_rope are written into ``cache`` in place at ``pos``
    (the reference returns updated copies); returns (y, cache)."""
    B = x.shape[0]
    H = cfg.n_heads
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, cfg, x,
                                                    positions)
    cache["c_kv"][:, pos:pos + 1] = c_kv_new.to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos:pos + 1] = k_rope_new[:, :, 0, :].to(
        cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Smax = c_kv.shape[1]
    mask = (torch.arange(Smax, device=x.device) <= pos)[None, None, None, :]
    scale = cfg.qk_dim ** -0.5
    rope_logits = einsum("bqhn,btn->bhqt", q_rope.float(), k_rope.float())
    if absorbed:
        wkv = params["wkv_b"].reshape(cfg.kv_lora_rank, H,
                                      cfg.qk_nope_dim + cfg.v_dim)
        w_k = wkv[:, :, : cfg.qk_nope_dim].float()        # (r, H, nope)
        w_v = wkv[:, :, cfg.qk_nope_dim:].float()         # (r, H, v)
        c = c_kv.float()
        q_lat = einsum("bqhn,rhn->bqhr", q_nope.float(), w_k)
        logits = (einsum("bqhr,btr->bhqt", q_lat, c) + rope_logits) * scale
        p = torch.softmax(logits.masked_fill(~mask, kref.NEG_INF), dim=-1)
        ctx = einsum("bhqt,btr->bqhr", p, c)
        out = einsum("bqhr,rhv->bqhv", ctx, w_v)
    else:
        k_nope, v = _mla_expand_kv(params, cfg, c_kv.to(x.dtype))
        logits = (einsum("bqhn,bthn->bhqt", q_nope.float(), k_nope.float())
                  + rope_logits) * scale
        p = torch.softmax(logits.masked_fill(~mask, kref.NEG_INF), dim=-1)
        out = einsum("bhqt,bthv->bqhv", p, v.float())
    out = out.reshape(B, 1, H * cfg.v_dim).to(x.dtype)
    y = einsum("bsh,hd->bsd", out, params["wo"]).to(x.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# Dense FFN: gated SiLU, or whisper's ungated GELU
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32, gated: bool = True) -> dict:
    p = dict(w_up=_dense(gen, (d_model, d_ff), dtype),
             w_down=_dense(gen, (d_ff, d_model), dtype))
    if gated:
        p["w_gate"] = _dense(gen, (d_model, d_ff), dtype)
    return p


def spec_mlp(gated: bool = True) -> dict:
    s = dict(w_up=("embed", "mlp"), w_down=("mlp", "embed"))
    if gated:
        s["w_gate"] = ("embed", "mlp")
    return s


def mlp_apply(params, x, gated: bool = True):
    """silu(x w_gate) * (x w_up), or ungated gelu(x w_up) in the tanh form
    (``jax.nn.gelu``'s default), then w_down."""
    up = einsum("bsd,df->bsf", x, params["w_up"]).to(x.dtype)
    if gated:
        gate = einsum("bsd,df->bsf", x, params["w_gate"]).to(x.dtype)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return einsum("bsf,fd->bsd", h, params["w_down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (DeepSeek-style: shared experts + routed top-k, capacity dispatch;
# also Jamba's FFN on odd layers)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared experts (DeepSeekMoE)
    d_ff_shared: int = 0         # total shared width (n_shared * d_ff_expert typically)
    capacity_factor: float = 1.25
    # AdaptGear hook: "dense" computes every expert for every token (the
    # dense-block kernel analogue; wins when E is tiny / density high),
    # "sparse" does capacity sort-scatter dispatch, "adaptive" picks by the
    # analytic density rule (top_k/E), mirroring core/selector.py.
    dispatch: str = "adaptive"


def init_moe(gen: torch.Generator, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """Router (float32 whatever ``dtype``, as the reference keeps it), the
    experts' gated FFNs stacked on axis 0 and, with ``n_shared``, the
    shared experts as one gated FFN of width ``d_ff_shared``
    (DeepSeekMoE)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = dict(
        router=_dense(gen, (d, E), torch.float32),
        w_gate=_dense(gen, (E, d, f), dtype),
        w_up=_dense(gen, (E, d, f), dtype),
        w_down=_dense(gen, (E, f, d), dtype),
    )
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, d, cfg.d_ff_shared, dtype)
    return p


def spec_moe(cfg: MoEConfig) -> dict:
    s = dict(router=("embed", None),
             w_gate=("expert", "embed", None),
             w_up=("expert", "embed", None),
             w_down=("expert", None, "embed"))
    if cfg.n_shared:
        s["shared"] = spec_mlp()
    return s


def moe_density(cfg: MoEConfig) -> float:
    return cfg.top_k / cfg.n_experts


def choose_moe_path(cfg: MoEConfig, n_tokens: int) -> str:
    """AdaptGear cost-model rule for MoE: dense path FLOPs scale with E,
    sparse path with top_k + dispatch overhead.  Dense wins only when the
    token-expert 'adjacency' is dense (few experts) or the token count is
    too small to amortize sort/scatter."""
    if cfg.dispatch != "adaptive":
        return cfg.dispatch
    dense_cost = float(cfg.n_experts)
    sparse_cost = cfg.top_k + 0.5 + 1e4 / max(n_tokens, 1)  # dispatch overhead
    return "dense" if dense_cost <= sparse_cost else "sparse"


def _moe_gates(params, cfg: MoEConfig, x2d):
    """Softmax router gates, the renormalised top-k (values (N, k) float32,
    expert ids (N, k)) and the Switch-style load-balancing loss."""
    logits = einsum("nd,de->ne", x2d.float(), params["router"])
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(gates, cfg.top_k, dim=-1)      # (N, k)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    me = gates.mean(0)
    flat = top_idx.reshape(-1)
    ce = torch.zeros((cfg.n_experts,), dtype=torch.float32,
                     device=x2d.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                            dtype=torch.float32, device=x2d.device))
    aux = cfg.n_experts * torch.sum(me * ce)
    return top_vals, top_idx, aux


def moe_apply_dense(params, cfg: MoEConfig, x2d):
    """Dense path: every expert for every token, masked combine.  The
    experts' outputs keep their float32 sums into the float32 combine, as
    the reference's do (:func:`bmm_f32`, without a float32 copy of the
    expert weights)."""
    top_vals, top_idx, aux = _moe_gates(params, cfg, x2d)
    N = x2d.shape[0]
    combine = torch.zeros((N, cfg.n_experts), dtype=torch.float32,
                          device=x2d.device).scatter_add_(1, top_idx,
                                                          top_vals)
    # einsum("nd,edf->enf") as a product broadcast over the experts:
    # torch.einsum would copy each (E, d, f) weight into a (d, E * f) one
    gate = torch.matmul(x2d[None], params["w_gate"]).to(x2d.dtype)
    up = torch.matmul(x2d[None], params["w_up"]).to(x2d.dtype)
    h = F.silu(gate) * up
    y = bmm_f32(h, params["w_down"])
    out = einsum("end,ne->nd", y, combine).to(x2d.dtype)
    return out, aux


def moe_apply_sparse(params, cfg: MoEConfig, x2d):
    """Sort-based capacity dispatch (token-choice, dropping).

    N*k assignments are sorted by expert id (stably, as ``jnp.argsort``);
    position-in-expert comes from the sorted rank minus the expert's start
    offset; tokens beyond capacity C are dropped (standard GShard/Switch
    semantics)."""
    N, d = x2d.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = x2d.device
    top_vals, top_idx, aux = _moe_gates(params, cfg, x2d)
    C = max(int(math.ceil(N * k / E * cfg.capacity_factor)), 1)

    e_flat = top_idx.reshape(-1)                            # (N*k,)
    t_flat = torch.arange(N, device=dev).repeat_interleave(k)
    w_flat = top_vals.reshape(-1)

    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    # start offset of each expert within the sorted list
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos = torch.arange(N * k, device=dev) - starts[e_sorted]  # rank in expert
    keep = pos < C
    slot = torch.where(keep, pos, 0)

    # scatter tokens into the (E, C, d) dispatch buffer
    buf = torch.zeros((E, C, d), dtype=x2d.dtype, device=dev)
    src = x2d[t_flat[order]]
    buf.index_put_((e_sorted, slot), torch.where(keep[:, None], src, 0),
                   accumulate=True)

    gate = einsum("ecd,edf->ecf", buf, params["w_gate"]).to(x2d.dtype)
    up = einsum("ecd,edf->ecf", buf, params["w_up"]).to(x2d.dtype)
    h = F.silu(gate) * up
    y = einsum("ecf,efd->ecd", h, params["w_down"]).to(x2d.dtype)

    # gather back + weighted combine
    out_e = y[e_sorted, slot]                               # (N*k, d)
    out_e = torch.where(keep[:, None], out_e, 0) * w_flat[order][:, None]
    out = torch.zeros((N, d), dtype=torch.float32, device=dev).index_put_(
        (t_flat[order],), out_e.float(), accumulate=True)
    return out.to(x2d.dtype), aux


def moe_apply(params, cfg: MoEConfig, x):
    """Routed FFN over x (B, S, d) by the path ``choose_moe_path`` picks
    for B * S tokens, plus the shared experts' FFN where there are any.
    Returns (out (B, S, d), aux loss)."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    if choose_moe_path(cfg, B * S) == "dense":
        out, aux = moe_apply_dense(params, cfg, x2d)
    else:
        out, aux = moe_apply_sparse(params, cfg, x2d)
    if cfg.n_shared:
        out = out + mlp_apply(params["shared"], x).reshape(B * S, d)
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba (selective SSM; Jamba's recurrent layer)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int          # expansion * d_model (Jamba: 2x)
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0      # 0 -> ceil(d_model/16)
    # "xla": the plain associative scan (torch ops); "identity": roofline
    # isolation stand-in (skip the recurrence); "pallas": the reference's
    # kernel core, here the CUDA kernel (kernels/mamba_scan.py)
    scan_core: str = "xla"

    @property
    def rank(self):
        return self.dt_rank or -(-self.d_model // 16)


def init_mamba(gen: torch.Generator, cfg: MambaConfig,
               dtype: torch.dtype = torch.float32) -> dict:
    """Mamba parameters; ``A_log`` and ``D`` are float32 whatever
    ``dtype``, as in the reference."""
    di, ds, r, dev = cfg.d_inner, cfg.d_state, cfg.rank, gen.device
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)[None, :]
    return dict(
        in_proj=_dense(gen, (cfg.d_model, 2 * di), dtype),
        conv_w=_dense(gen, (cfg.d_conv, di), dtype),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        x_proj=_dense(gen, (di, r + 2 * ds), dtype),
        dt_proj=_dense(gen, (r, di), dtype),
        dt_bias=torch.zeros((di,), dtype=dtype, device=dev),
        A_log=torch.log(A.repeat(di, 1)),
        D=torch.ones((di,), dtype=torch.float32, device=dev),
        out_proj=_dense(gen, (di, cfg.d_model), dtype),
    )


def spec_mamba(cfg: MambaConfig) -> dict:
    return dict(in_proj=("embed", "mlp"), conv_w=(None, "mlp"),
                conv_b=("mlp",), x_proj=("mlp", None), dt_proj=(None, "mlp"),
                dt_bias=("mlp",), A_log=("mlp", None), D=("mlp",),
                out_proj=("mlp", "embed"))


def _mamba_inner(params, cfg: MambaConfig, xz, conv_state=None):
    """Shared pre-scan compute. xz: (B, T, 2*d_inner).  Returns x, z, dt
    (float32, post-softplus), Bc, Cc and the new conv state (the last
    d_conv - 1 conv inputs)."""
    x, z = torch.chunk(xz, 2, dim=-1)
    B, T, di = x.shape
    # causal depthwise conv1d
    if conv_state is None:
        conv_state = x.new_zeros((B, cfg.d_conv - 1, di))
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_conv_state = xp[:, -(cfg.d_conv - 1):, :]
    x = sum(xp[:, i:i + T, :] * params["conv_w"][i] for i in range(cfg.d_conv))
    x = F.silu(x + params["conv_b"])
    proj = einsum("btd,dr->btr", x, params["x_proj"]).to(x.dtype)
    dt, Bc, Cc = torch.split(proj, [cfg.rank, cfg.d_state, cfg.d_state],
                             dim=-1)
    # the reference keeps this product's float32 sums (no cast to x.dtype)
    dt = F.softplus(einsum("btr,rd->btd", dt.float(),
                           params["dt_proj"].float()) + params["dt_bias"])
    return x, z, dt.float(), Bc, Cc, new_conv_state


def _ssm_scan(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """h_t = dA_t h_{t-1} + dBx_t along axis 1 from h_0 = 0, for every t,
    as an associative scan of the combine (a1, b1), (a2, b2) -> (a2 a1,
    a2 b1 + b2) (Hillis-Steele doubling: log2 T rounds of plain torch ops,
    the counterpart of the reference's ``jax.lax.associative_scan``).
    Without autograd it overwrites and returns ``dBx`` (``dA`` is
    overwritten too), which saves a copy of the (B, T, d_inner, d_state)
    states a round; where autograd records it (grad enabled and an input
    requiring grad) each round makes new tensors instead, with the same
    arithmetic, so the backward finds what it saved unchanged."""
    a, b = dA, dBx
    T, step = a.shape[1], 1
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        while step < T:
            b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step]
                           + b[:, step:]], dim=1)
            if 2 * step < T:
                a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]],
                              dim=1)
            step *= 2
        return b
    while step < T:
        tmp = a[:, step:] * b[:, :-step]
        tmp += b[:, step:]
        b[:, step:] = tmp
        del tmp
        if 2 * step < T:
            a[:, step:] = a[:, step:] * a[:, :-step]
        step *= 2
    return b


def _mamba_states(dt, xs, Bc, A):
    """Every state h_t (B, T, d_inner, d_state) float32 of the plain
    associative scan."""
    dA = torch.exp(dt[..., None] * A)                      # (B,T,di,ds)
    dBx = (dt * xs.float())[..., None] * Bc.float()[:, :, None, :]
    return _ssm_scan(dA, dBx)


def mamba_apply(params, cfg: MambaConfig, x, return_state: bool = False):
    """Full-sequence selective scan by ``cfg.scan_core``: the plain
    associative scan (``"xla"``), the CUDA kernel (``"pallas"``, through
    ``mamba_scan_trainable``, as the reference calls it: the reference's
    preconditions on T hold; its backward recomputes through the plain
    oracle) or the identity stand-in.  With ``return_state`` also returns
    the decode cache (final h + conv tail); under the kernel and identity
    cores h comes from the plain scan, as in the reference."""
    xz = einsum("btd,de->bte", x, params["in_proj"]).to(x.dtype)
    xs, z, dt, Bc, Cc, conv_state = _mamba_inner(params, cfg, xz)
    A = -torch.exp(params["A_log"])                        # (di, ds)
    hs = None
    if cfg.scan_core == "identity":
        # roofline isolation: everything but the recurrence
        y = xs.float() * params["D"]
    elif cfg.scan_core == "pallas":
        from repro_torch.kernels.mamba_scan import mamba_scan_trainable
        y = mamba_scan_trainable(xs.float().contiguous(), dt.contiguous(),
                                 Bc.float().contiguous(),
                                 Cc.float().contiguous(), A,
                                 params["D"]).float()
    else:
        hs = _mamba_states(dt, xs, Bc, A)
        y = einsum("btds,bts->btd", hs, Cc.float())
        y = y + xs.float() * params["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = einsum("btd,de->bte", y, params["out_proj"]).to(x.dtype)
    if not return_state:
        return out
    if hs is None:
        hs = _mamba_states(dt, xs, Bc, A)
    return out, dict(h=hs[:, -1].clone(), conv=conv_state.to(x.dtype))


def init_mamba_cache(cfg: MambaConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    return dict(h=torch.zeros((batch, cfg.d_inner, cfg.d_state),
                              dtype=torch.float32, device=device),
                conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                 dtype=dtype, device=device))


def spec_mamba_cache(cfg: MambaConfig) -> dict:
    return dict(h=("batch", "mlp", None), conv=("batch", None, "mlp"))


def mamba_decode(params, cfg: MambaConfig, x, cache):
    """Single-token recurrent step. x: (B, 1, d).  Returns (y, new cache);
    the caller writes the cache."""
    xz = einsum("btd,de->bte", x, params["in_proj"]).to(x.dtype)
    xs, z, dt, Bc, Cc, new_conv = _mamba_inner(params, cfg, xz,
                                               cache["conv"])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A)                  # (B,di,ds)
    dBx = (dt[:, 0] * xs[:, 0].float())[..., None] * \
        Bc[:, 0].float()[:, None, :]
    h = dA * cache["h"] + dBx
    y = einsum("bds,bs->bd", h, Cc[:, 0].float())
    y = y + xs[:, 0].float() * params["D"]
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = einsum("bd,de->be", y, params["out_proj"]).to(x.dtype)
    return out[:, None, :], dict(h=h, conv=new_conv.to(cache["conv"].dtype))


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): time-mix with data-dependent decay + channel-mix
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    d_ff: int = 0                 # channel-mix width (3.5x d_model default)
    lora_rank: int = 64           # decay LoRA rank
    chunk: int = 64               # chunked-parallel block length
    # "xla": the plain chunked form (rwkv6_chunked); "pallas": the
    # reference's Pallas core, here the CUDA kernel (rwkv6_chunked_kernel);
    # "identity": roofline isolation stand-in (skip the WKV recurrence)
    wkv_core: str = "xla"

    @property
    def n_heads(self):
        return self.d_model // self.head_dim


def init_rwkv6(gen: torch.Generator, cfg: RWKV6Config,
               dtype: torch.dtype = torch.float32) -> dict:
    """Time-mix parameters; ``w0`` and ``u`` are float32 whatever
    ``dtype``, as in the reference."""
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    dev = gen.device

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)

    return dict(
        # token-shift interpolation weights (static per-channel mu, as the
        # reference keeps them)
        mu_r=half(), mu_k=half(), mu_v=half(), mu_w=half(), mu_g=half(),
        wr=_dense(gen, (d, d), dtype),
        wk=_dense(gen, (d, d), dtype),
        wv=_dense(gen, (d, d), dtype),
        wg=_dense(gen, (d, d), dtype),
        # data-dependent decay: w_t = exp(-exp(w0 + lora(x)))
        w0=torch.zeros((d,), dtype=torch.float32, device=dev),
        w_lora_a=_dense(gen, (d, cfg.lora_rank), dtype),
        w_lora_b=_dense(gen, (cfg.lora_rank, d), dtype),
        u=nn.trunc_normal(gen, (H, dh)).float(),                  # bonus
        ln_x=torch.ones((d,), dtype=dtype, device=dev),           # group-norm
        wo=_dense(gen, (d, d), dtype),
    )


def spec_rwkv6(cfg: RWKV6Config) -> dict:
    return dict(mu_r=(None,), mu_k=(None,), mu_v=(None,), mu_w=(None,),
                mu_g=(None,),
                wr=("embed", "mlp"), wk=("embed", "mlp"), wv=("embed", "mlp"),
                wg=("embed", "mlp"), w0=(None,), w_lora_a=("embed", None),
                w_lora_b=(None, "mlp"), u=(None, None), ln_x=(None,),
                wo=("mlp", "embed"))


def _rwkv6_rkvwg(params, cfg: RWKV6Config, x, x_prev):
    """Token-shift mixes x_t with x_{t-1}; x_prev: (B,1,d) last token of the
    previous segment (zeros at sequence start).  Returns r, k, v (B,H,T,dh)
    in x.dtype, w (B,H,T,dh) float32 and g (B,T,d)."""
    B, T, d = x.shape
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)             # shifted

    def mix(mu):
        return x + (xs - x) * mu

    r = einsum("btd,de->bte", mix(params["mu_r"]), params["wr"]).to(x.dtype)
    k = einsum("btd,de->bte", mix(params["mu_k"]), params["wk"]).to(x.dtype)
    v = einsum("btd,de->bte", mix(params["mu_v"]), params["wv"]).to(x.dtype)
    g = einsum("btd,de->bte", mix(params["mu_g"]), params["wg"]).to(x.dtype)
    inner = einsum("btd,dr->btr", mix(params["mu_w"]),
                   params["w_lora_a"]).to(x.dtype)
    # the reference keeps this product's float32 sums (no cast to x.dtype)
    lora = einsum("btr,rd->btd", torch.tanh(inner).float(),
                  params["w_lora_b"].float())
    # decay rate clamped to exp(0.405) = 1.5, so log w >= -1.5 per step
    rate = torch.clamp(params["w0"] + lora, -20.0, 0.405)
    w = torch.exp(-torch.exp(rate))                        # (B,T,d) in (0,1)
    H, dh = cfg.n_heads, cfg.head_dim

    def resh(a):
        return a.reshape(B, T, H, dh).transpose(1, 2)

    return resh(r), resh(k), resh(v), resh(w.float()), g


def rwkv6_time_mix(params, cfg: RWKV6Config, x, x_prev=None, state=None,
                   use_chunked: bool = True):
    """Full-sequence RWKV6 attention-free mixing.  Returns (out, (x_last,
    S_last)) so segments/decode can be chained.  The WKV core follows the
    reference's rule: ``"pallas"`` (the CUDA kernel) only from a zero
    state with T % chunk == 0 and T > chunk, where its S_last is returned
    as zeros, as the reference's is; the chunked form under the same
    length rule; else the sequential recurrence."""
    B, T, d = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    if x_prev is None:
        x_prev = x.new_zeros((B, 1, d))
    r, k, v, w, g = _rwkv6_rkvwg(params, cfg, x, x_prev)
    chunkable = T % cfg.chunk == 0 and T > cfg.chunk
    if cfg.wkv_core == "identity" and use_chunked:
        # roofline isolation: everything but the recurrence
        o = v.float()
        S = state if state is not None else torch.zeros(
            (B, H, dh, dh), dtype=torch.float32, device=x.device)
    elif (cfg.wkv_core == "pallas" and use_chunked and state is None
          and chunkable):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, params["u"])):
            raise NotImplementedError(
                'wkv_core="pallas" runs the forward-only rwkv6_chunked '
                "kernel, which has no gradient (the reference's "
                'rwkv6_chunked_pallas has no VJP): train RWKV-6 under '
                'wkv_core="xla", the plain chunked form')
        from repro_torch.kernels.rwkv6_chunked import rwkv6_chunked_kernel
        o = rwkv6_chunked_kernel(r.contiguous(), k.contiguous(),
                                 v.contiguous(), w.contiguous(), params["u"],
                                 chunk=cfg.chunk).float()
        S = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    elif use_chunked and chunkable:
        from repro_torch.kernels.rwkv6_chunked import rwkv6_chunked
        o, S = rwkv6_chunked(r, k, v, w, params["u"], chunk=cfg.chunk,
                             state=state)
    else:
        o, S = _rwkv6_sequential(r, k, v, w, params["u"], state)
    # per-head group norm
    oh = o.transpose(1, 2).float()                          # (B,T,H,dh)
    mu = oh.mean(-1, keepdim=True)
    var = oh.var(-1, keepdim=True, correction=0)
    o = ((oh - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, d)
    o = (o * params["ln_x"]).to(x.dtype)
    o = o * F.silu(g)
    out = einsum("btd,de->bte", o, params["wo"]).to(x.dtype)
    return out, (x[:, -1:], S)


def _rwkv6_sequential(r, k, v, w, u, state):
    """The recurrence step by step from ``state`` (zeros if None): (o
    (B,H,T,dh) float32, S (B,H,dh,dh) float32)."""
    return kref.rwkv6_recurrence(r, k, v, w, u, state)


def init_rwkv6_cm(gen: torch.Generator, cfg: RWKV6Config,
                  dtype: torch.dtype = torch.float32) -> dict:
    d = cfg.d_model
    ff = cfg.d_ff or int(3.5 * d)
    dev = gen.device
    return dict(mu_k=torch.full((d,), 0.5, dtype=dtype, device=dev),
                mu_r=torch.full((d,), 0.5, dtype=dtype, device=dev),
                wk=_dense(gen, (d, ff), dtype), wv=_dense(gen, (ff, d), dtype),
                wr=_dense(gen, (d, d), dtype))


def spec_rwkv6_cm(cfg: RWKV6Config) -> dict:
    return dict(mu_k=(None,), mu_r=(None,), wk=("embed", "mlp"),
                wv=("mlp", "embed"), wr=("embed", "mlp"))


def rwkv6_channel_mix(params, x, x_prev=None):
    """Channel-mix (squared-ReLU FFN gated by sigmoid(r)); returns (out,
    x_last)."""
    B, T, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((B, 1, d))
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)
    xk = x + (xs - x) * params["mu_k"]
    xr = x + (xs - x) * params["mu_r"]
    kk = einsum("btd,df->btf", xk, params["wk"]).to(x.dtype)
    kk = torch.square(torch.relu(kk))
    vv = einsum("btf,fd->btd", kk, params["wv"]).to(x.dtype)
    rr = torch.sigmoid(einsum("btd,de->bte", xr, params["wr"]).to(x.dtype))
    return rr * vv, x[:, -1:]
