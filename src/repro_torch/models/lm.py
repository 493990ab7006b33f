"""LM-family model: decoder-only dense, MoE and MLA transformers (with
RoPE or Qwen2-VL's M-RoPE), RWKV-6 and Jamba, and Whisper's
encoder-decoder.

Counterpart of ``repro/models/lm.py`` for layer kinds ``attn_mlp`` /
``attn_moe`` (GQA attention + a gated FFN or a routed MoE FFN with shared
experts, pre-RMSNorm; InternLM2, Qwen2.5, CodeQwen, Mistral-Large,
DeepSeekMoE), ``mla_mlp`` / ``mla_moe`` (multi-head latent attention;
DeepSeek-V3, with its multi-token prediction block), ``rwkv`` (RWKV-6
time-mix + channel-mix, pre-RMSNorm; RWKV6-7B) and ``jamba_period`` (8
pre-RMSNorm layers: Mamba mixers with attention at layer 3, a dense FFN on
even layers and a routed MoE FFN on odd ones; Jamba-v0.1), and ``enc`` /
``dec`` (Whisper's encoder and decoder layers: pre-LayerNorm with biases,
non-causal self-attention without RoPE in the encoder, causal
self-attention and cross-attention over the encoder's output in the
decoder, an ungated GELU FFN).  Qwen2-VL is ``attn_mlp`` under M-RoPE:
positions (3, B, S), temporal, height and width.

A model is a sequence of homogeneous layer groups.  With ``scan_layers``
each group's parameters and decode caches are stacked on axis 0, as in the
reference; where the reference scans over a stack, the port loops over it
(views, no copies), and decoding writes each layer's new cache entries
into its stacked cache in place instead of returning updated copies:
attention's k/v and MLA's latent c_kv and k_rope at ``pos``, RWKV's
state ``S`` and token-shift inputs ``x_tm`` and ``x_cm``, Mamba's state
``h`` and conv tail ``conv``.

``param_specs`` and ``cache_specs`` give the logical axes of every leaf
of ``init_params`` and ``init_cache`` (the reference's spec trees), which
``launch/sharding.py`` resolves onto a mesh.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ref as kref
from repro_torch.layers import nn
from repro_torch.layers import rope as rope_mod
from repro_torch.models import blocks as blk
from repro_torch.tree import tree_leaves as _leaves
from repro_torch.tree import tree_map as _tree_map
from repro_torch.tree import tree_unflatten as _unflatten

Params = Any

DTYPES = dict(float32=torch.float32, bfloat16=torch.bfloat16,
              float16=torch.float16)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"          # decoder | encdec
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab: int = 1000
    vocab_pad_to: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    dtype: str = "float32"
    norm_eps: float = 1e-6

    attn_type: str = "gqa"           # gqa | mla
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "adaptive"   # AdaptGear hook
    aux_loss_coef: float = 0.01

    # hybrid / attention-free
    layer_pattern: str = "uniform"   # uniform | jamba | rwkv
    mamba_d_state: int = 16
    mamba_expand: int = 2

    # modality / structure
    input_mode: str = "tokens"       # tokens | embeds (vlm & audio stubs)
    mrope_sections: tuple | None = None
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # deepseek-v3 multi-token prediction
    mtp: bool = False
    mtp_weight: float = 0.3

    # execution
    attn_core: str = "softmax"       # softmax | flash | identity
    mamba_core: str = "xla"          # xla | pallas | identity
    wkv_core: str = "xla"            # xla | pallas | identity
    remat: str = "dots"              # none | full | dots
    scan_layers: bool = True
    subquadratic: bool = False       # eligible for long_500k
    rwkv_chunk: int = 32

    @property
    def torch_dtype(self) -> torch.dtype:
        """The model dtype (the reference's ``jdtype``)."""
        return DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    def attn_cfg(self, causal=True, use_rope=True) -> blk.AttnConfig:
        return blk.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, kv_heads=self.kv_heads,
            head_dim=self.head_dim, qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta, mrope_sections=self.mrope_sections,
            causal=causal, use_rope=use_rope, attn_core=self.attn_core)

    def mla_cfg(self) -> blk.MLAConfig:
        return blk.MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            q_lora_rank=self.q_lora_rank, kv_lora_rank=self.kv_lora_rank,
            qk_nope_dim=self.qk_nope_dim, qk_rope_dim=self.qk_rope_dim,
            v_dim=self.v_head_dim, rope_theta=self.rope_theta,
            attn_core=self.attn_core)

    def moe_cfg(self) -> blk.MoEConfig:
        return blk.MoEConfig(
            d_model=self.d_model, n_experts=self.n_experts, top_k=self.top_k,
            d_ff_expert=self.d_ff_expert, n_shared=self.n_shared_experts,
            d_ff_shared=self.n_shared_experts * self.d_ff_expert,
            capacity_factor=self.capacity_factor, dispatch=self.moe_dispatch)

    def mamba_cfg(self) -> blk.MambaConfig:
        return blk.MambaConfig(d_model=self.d_model,
                               d_inner=self.mamba_expand * self.d_model,
                               d_state=self.mamba_d_state,
                               scan_core=self.mamba_core)

    def rwkv_cfg(self) -> blk.RWKV6Config:
        return blk.RWKV6Config(d_model=self.d_model, head_dim=64,
                               d_ff=self.d_ff, chunk=self.rwkv_chunk,
                               wkv_core=self.wkv_core)

    def layer_groups(self) -> list[tuple[str, int]]:
        """[(kind, n_layers_in_group), ...] in execution order."""
        if self.family == "encdec":
            return [("enc", self.encoder_layers), ("dec", self.n_layers)]
        if self.layer_pattern == "rwkv":
            return [("rwkv", self.n_layers)]
        if self.layer_pattern == "jamba":
            assert self.n_layers % 8 == 0
            return [("jamba_period", self.n_layers // 8)]
        mixer = "mla" if self.attn_type == "mla" else "attn"
        if self.n_experts:
            groups = []
            if self.first_k_dense:
                groups.append((f"{mixer}_mlp", self.first_k_dense))
            groups.append((f"{mixer}_moe", self.n_layers - self.first_k_dense))
            return groups
        return [(f"{mixer}_mlp", self.n_layers)]


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _norm_init(d, dtype, device, with_bias: bool = False):
    p = dict(scale=torch.ones((d,), dtype=dtype, device=device))
    if with_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _norm_spec(with_bias: bool = False) -> dict:
    s = dict(scale=(None,))
    if with_bias:
        s["bias"] = (None,)
    return s


def _norm_apply(p, x, eps):
    """LayerNorm where the norm has a bias (whisper's), else RMSNorm."""
    if "bias" in p:
        return nn.layer_norm(x, p["scale"], p["bias"], eps)
    return nn.rms_norm(x, p["scale"], eps)


# the kinds of one attention (GQA or MLA) layer and one FFN (dense or MoE)
TRANSFORMER_KINDS = ("attn_mlp", "attn_moe", "mla_mlp", "mla_moe")

# a jamba_period's 8 sub-layers: attention at JAMBA_ATTN, Mamba elsewhere;
# the MoE FFN on odd sub-layers, the dense FFN on even ones
JAMBA_PERIOD = 8
JAMBA_ATTN = 3


def _jamba_ffn(lp, cfg: ModelConfig, i: int, x):
    """The FFN half of a jamba_period's sub-layer ``i``: the MoE FFN on odd
    sub-layers, the dense FFN on even ones.  Returns (x, aux loss)."""
    h = _norm_apply(lp["norm2"], x, cfg.norm_eps)
    if i % 2:
        h, aux = blk.moe_apply(lp["ffn"], cfg.moe_cfg(), h)
        return x + h, aux
    return x + blk.mlp_apply(lp["ffn"], h), 0.0


def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    dt, d = cfg.torch_dtype, cfg.d_model
    if kind in ("enc", "dec"):
        norms = ("norm1", "norm2") + (("norm3",) if kind == "dec" else ())
        p = {n: _norm_init(d, dt, gen.device, with_bias=True) for n in norms}
        p["attn"] = blk.init_attention(
            gen, cfg.attn_cfg(causal=kind == "dec", use_rope=False), dt)
        if kind == "dec":
            p["cross"] = blk.init_attention(
                gen, cfg.attn_cfg(causal=False, use_rope=False), dt)
        p["ffn"] = blk.init_mlp(gen, d, cfg.d_ff, dt, gated=False)
        return p
    if kind == "jamba_period":
        return {f"l{i}": dict(
            norm1=_norm_init(d, dt, gen.device),
            norm2=_norm_init(d, dt, gen.device),
            mixer=(blk.init_attention(gen, cfg.attn_cfg(), dt)
                   if i == JAMBA_ATTN
                   else blk.init_mamba(gen, cfg.mamba_cfg(), dt)),
            ffn=(blk.init_moe(gen, cfg.moe_cfg(), dt) if i % 2
                 else blk.init_mlp(gen, d, cfg.d_ff, dt)))
            for i in range(JAMBA_PERIOD)}
    if kind not in TRANSFORMER_KINDS + ("rwkv",):
        raise ValueError(kind)
    p = dict(norm1=_norm_init(d, dt, gen.device),
             norm2=_norm_init(d, dt, gen.device))
    if kind == "rwkv":
        rc = cfg.rwkv_cfg()
        return dict(p, tm=blk.init_rwkv6(gen, rc, dt),
                    cm=blk.init_rwkv6_cm(gen, rc, dt))
    mixer, ffn = kind.split("_")
    p["attn"] = (blk.init_attention(gen, cfg.attn_cfg(), dt)
                 if mixer == "attn" else blk.init_mla(gen, cfg.mla_cfg(), dt))
    p["ffn"] = (blk.init_mlp(gen, d, cfg.d_ff, dt) if ffn == "mlp"
                else blk.init_moe(gen, cfg.moe_cfg(), dt))
    return p


def spec_layer(cfg: ModelConfig, kind: str) -> dict:
    """The logical axes of ``init_layer``'s leaves (the reference's
    ``spec_layer``)."""
    if kind in TRANSFORMER_KINDS:
        mixer, ffn = kind.split("_")
        return dict(
            norm1=_norm_spec(), norm2=_norm_spec(),
            attn=(blk.spec_attention(cfg.attn_cfg()) if mixer == "attn"
                  else blk.spec_mla(cfg.mla_cfg())),
            ffn=(blk.spec_mlp() if ffn == "mlp"
                 else blk.spec_moe(cfg.moe_cfg())))
    if kind == "rwkv":
        rc = cfg.rwkv_cfg()
        return dict(norm1=_norm_spec(), norm2=_norm_spec(),
                    tm=blk.spec_rwkv6(rc), cm=blk.spec_rwkv6_cm(rc))
    if kind == "jamba_period":
        return {f"l{i}": dict(
            norm1=_norm_spec(), norm2=_norm_spec(),
            mixer=(blk.spec_attention(cfg.attn_cfg()) if i == JAMBA_ATTN
                   else blk.spec_mamba(cfg.mamba_cfg())),
            ffn=(blk.spec_moe(cfg.moe_cfg()) if i % 2 else blk.spec_mlp()))
            for i in range(JAMBA_PERIOD)}
    if kind == "enc":
        return dict(norm1=_norm_spec(True), norm2=_norm_spec(True),
                    attn=blk.spec_attention(cfg.attn_cfg(causal=False)),
                    ffn=blk.spec_mlp(gated=False))
    if kind == "dec":
        return dict(norm1=_norm_spec(True), norm2=_norm_spec(True),
                    norm3=_norm_spec(True),
                    attn=blk.spec_attention(cfg.attn_cfg()),
                    cross=blk.spec_attention(cfg.attn_cfg(causal=False)),
                    ffn=blk.spec_mlp(gated=False))
    raise ValueError(kind)


def is_logical(t) -> bool:
    """A leaf of a logical-axis spec tree: a tuple of axis names and
    None."""
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in t)


def _stacked_spec(spec, lead):
    """``spec`` with ``lead`` (the stacked layer axis's name, or None)
    before every leaf's axes."""
    return _tree_map(lambda t: (lead,) + t, spec, is_leaf=is_logical)


def _ffn_apply(params, cfg: ModelConfig, kind: str, h):
    """The FFN half of a transformer layer on the normed ``h``: the dense
    FFN for ``*_mlp``, the MoE FFN for ``*_moe``.  Returns (out, aux
    loss or None)."""
    if kind.endswith("_moe"):
        return blk.moe_apply(params["ffn"], cfg.moe_cfg(), h)
    return blk.mlp_apply(params["ffn"], h), None


def _cross_kv(params, cfg: ModelConfig, enc_out, dtype):
    """A decoder layer's cross-attention k and v (B, Se, KV, dh) from the
    encoder's output, with their biases."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.kv_heads, cfg.head_dim)
    kx = blk.einsum("bsd,dh->bsh", enc_out,
                    params["wk"]).to(dtype).reshape(shape)
    vx = blk.einsum("bsd,dh->bsh", enc_out,
                    params["wv"]).to(dtype).reshape(shape)
    if cfg.qkv_bias:
        kx = kx + params["bk"].reshape(cfg.kv_heads, cfg.head_dim)
        vx = vx + params["bv"].reshape(cfg.kv_heads, cfg.head_dim)
    return kx, vx


def _cross_ffn(params, cfg: ModelConfig, x, positions, kv):
    """A decoder layer's second half on ``x``: cross-attention over the
    encoder's (k, v), then the ungated FFN, each pre-LayerNorm with a
    residual."""
    eps = cfg.norm_eps
    h = _norm_apply(params["norm2"], x, eps)
    x = x + blk.attention_apply(params["cross"], cfg.attn_cfg(
        causal=False, use_rope=False), h, positions, kv_override=kv)
    h = _norm_apply(params["norm3"], x, eps)
    return x + blk.mlp_apply(params["ffn"], h, gated=False)


def layer_apply(params, cfg: ModelConfig, kind: str, x, positions,
                enc_out=None):
    """Full-sequence layer (``enc_out``: the encoder's output, for a
    ``dec`` layer). Returns (x, aux_loss)."""
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "enc":
        h = _norm_apply(params["norm1"], x, eps)
        x = x + blk.attention_apply(params["attn"], cfg.attn_cfg(
            causal=False, use_rope=False), h, positions)
        h = _norm_apply(params["norm2"], x, eps)
        return x + blk.mlp_apply(params["ffn"], h, gated=False), aux
    if kind == "dec":
        h = _norm_apply(params["norm1"], x, eps)
        x = x + blk.attention_apply(params["attn"], cfg.attn_cfg(
            causal=True, use_rope=False), h, positions)
        kv = _cross_kv(params["cross"], cfg, enc_out, x.dtype)
        return _cross_ffn(params, cfg, x, positions, kv), aux
    if kind == "jamba_period":
        for i in range(JAMBA_PERIOD):
            lp = params[f"l{i}"]
            h = _norm_apply(lp["norm1"], x, eps)
            if i == JAMBA_ATTN:
                h = blk.attention_apply(lp["mixer"], cfg.attn_cfg(), h,
                                        positions)
            else:
                h = blk.mamba_apply(lp["mixer"], cfg.mamba_cfg(), h)
            x, a = _jamba_ffn(lp, cfg, i, x + h)
            aux = aux + a
        return x, aux
    if kind == "rwkv":
        rc = cfg.rwkv_cfg()
        h = _norm_apply(params["norm1"], x, eps)
        h, _ = blk.rwkv6_time_mix(params["tm"], rc, h)
        x = x + h
        h = _norm_apply(params["norm2"], x, eps)
        h, _ = blk.rwkv6_channel_mix(params["cm"], h)
        return x + h, aux
    if kind not in TRANSFORMER_KINDS:
        raise ValueError(kind)
    h = _norm_apply(params["norm1"], x, eps)
    if kind.startswith("attn"):
        h = blk.attention_apply(params["attn"], cfg.attn_cfg(), h, positions)
    else:
        h = blk.mla_apply(params["attn"], cfg.mla_cfg(), h, positions)
    x = x + h
    h = _norm_apply(params["norm2"], x, eps)
    h, a = _ffn_apply(params, cfg, kind, h)
    return x + h, aux if a is None else a


# ---------------------------------------------------------------------------
# layer stacks
# ---------------------------------------------------------------------------

def _stack(layers: list) -> Params:
    return _tree_map(lambda *xs: torch.stack(xs), *layers)


def _layers(group, cfg: ModelConfig, unbind: bool = False) -> list:
    """Per-layer views of a group: slices of its stacks (``scan_layers``)
    or the reference's list of layers.  With ``unbind`` the slices come
    from ``Tensor.unbind``, whose backward stacks the layers' gradients
    once (an indexing slice's backward would allocate a whole stack per
    layer); the views must not be written in place."""
    if not cfg.scan_layers:
        return list(group)
    if unbind:
        parts = [a.unbind(0) for a in _leaves(group)]
        return [_unflatten(group, [p[i] for p in parts])
                for i in range(len(parts[0]))]
    n = _leaves(group)[0].shape[0]
    return [_tree_map(lambda a, i=i: a[i], group) for i in range(n)]


# ---------------------------------------------------------------------------
# whole-model init / forward
# ---------------------------------------------------------------------------

def make_generator(seed: int, device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.Generator:
    """The explicit generator ``init_params`` draws from, on ``device``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _init_stacked(gen: torch.Generator, cfg: ModelConfig, kind: str,
                  n: int) -> Params:
    """A group's ``n`` layers drawn in order, as ``_stack`` of them would
    hold them, without the list: the stacks are allocated once and filled
    layer by layer (one layer's tensors alive beside them; a group of one
    layer is viewed with a leading axis, no copy)."""
    stack = None
    for i in range(n):
        layer = init_layer(gen, cfg, kind)
        if n == 1:
            return _tree_map(lambda a: a.unsqueeze(0), layer)
        if stack is None:
            stack = _tree_map(lambda a: a.new_empty((n,) + a.shape), layer)
        _tree_map(lambda s, a: s[i].copy_(a), stack, layer)
        del layer
    return stack


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters drawn from ``gen`` on its device (the reference's key):
    embed, the untied head, each group's layers in order, then with
    ``cfg.mtp`` the multi-token prediction block (``mtp``: norm, proj (2d,
    d) and one layer of ``mtp_kind``).  An encoder-decoder model's
    ``final_norm`` is a LayerNorm (with a bias), and it has the encoder's
    ``enc_final_norm`` too."""
    dt, dev = cfg.torch_dtype, gen.device
    V = cfg.padded_vocab
    encdec = cfg.family == "encdec"
    p = dict(embed=nn.trunc_normal(gen, (V, cfg.d_model)).to(dt),
             final_norm=_norm_init(cfg.d_model, dt, dev, with_bias=encdec))
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.trunc_normal(gen, (cfg.d_model, V)).to(dt)
    p["groups"] = [
        _init_stacked(gen, cfg, kind, n) if cfg.scan_layers
        else [init_layer(gen, cfg, kind) for _ in range(n)]
        for kind, n in cfg.layer_groups()]
    if encdec:
        p["enc_final_norm"] = _norm_init(cfg.d_model, dt, dev,
                                         with_bias=True)
    if cfg.mtp:
        p["mtp"] = dict(norm=_norm_init(cfg.d_model, dt, dev),
                        proj=nn.lecun_normal(gen, (2 * cfg.d_model,
                                                   cfg.d_model)).to(dt),
                        block=init_layer(gen, cfg, mtp_kind(cfg)))
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``init_params`` (the reference's
    ``param_specs``): a tuple of names or None per dim, each group's
    stacked layer axis ``"layer"`` with ``scan_layers``, else a list of
    one spec per layer."""
    s = dict(embed=("vocab", "embed"),
             final_norm=_norm_spec(cfg.family == "encdec"))
    if not cfg.tie_embeddings:
        s["lm_head"] = ("embed", "vocab")
    s["groups"] = [
        _stacked_spec(spec_layer(cfg, kind), "layer") if cfg.scan_layers
        else [spec_layer(cfg, kind)] * n
        for kind, n in cfg.layer_groups()]
    if cfg.family == "encdec":
        s["enc_final_norm"] = _norm_spec(True)
    if cfg.mtp:
        s["mtp"] = dict(norm=_norm_spec(), proj=("embed", "embed"),
                        block=spec_layer(cfg, mtp_kind(cfg)))
    return s


def mtp_kind(cfg: ModelConfig) -> str:
    """The layer kind of DeepSeek-V3's multi-token prediction block: one
    dense-FFN layer with the model's attention."""
    return "attn_mlp" if cfg.attn_type == "gqa" else "mla_mlp"


def _saves_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``, the counterpart
    of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of plain 2-D matrix products, recompute everything else.
    ``blk.einsum`` lowers a product with no batch dimensions (``"bsd,dh->
    bsh"``) to a ``bmm`` over a batch of one, and one with batch dimensions
    (attention's ``"bhgsd,bhtd->bhgst"``) to a ``bmm`` over their product,
    so a ``bmm`` counts as plain where its batch is one (as would an
    attention product at batch 1 with one kv head)."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(cfg: ModelConfig, kind: str):
    """``layer_apply`` under ``torch.utils.checkpoint`` as ``cfg.remat``
    asks: ``"full"`` keeps only the layer's inputs and recomputes the layer
    in the backward, ``"dots"`` also keeps the plain matrix products'
    outputs (``_saves_dots``)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _saves_dots)

    def run(lp, x, positions, enc_out):
        return checkpoint(layer_apply, lp, cfg, kind, x, positions, enc_out,
                          use_reentrant=False, **kw)

    return run


def _run_group(group_params, cfg: ModelConfig, kind: str, x, positions,
               enc_out=None):
    """Loop a homogeneous layer group (``enc_out``: the encoder's output,
    for the ``dec`` group).  Where autograd records the layers (grad
    enabled, and the params, ``x`` or ``enc_out`` requiring grad),
    ``cfg.remat`` says what the backward recomputes, as the reference's
    ``jax.checkpoint`` around each layer: ``"none"`` nothing, ``"full"``
    the whole layer, ``"dots"`` all but the plain matrix products; the
    encoder's output is an input of each checkpointed decoder layer, so
    its gradient reaches the encoder through the cross k/v.  A recomputed
    layer runs its forward again in the backward, kernels included.
    Without autograd (prefill, decode) the layers just run."""
    recorded = torch.is_grad_enabled() and (
        x.requires_grad
        or (enc_out is not None and enc_out.requires_grad)
        or any(t.requires_grad for t in _leaves(group_params)))
    if recorded and cfg.remat in ("full", "dots"):
        run = _checkpointed(cfg, kind)
    else:
        def run(lp, x, positions, enc_out):
            return layer_apply(lp, cfg, kind, x, positions, enc_out)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(group_params, cfg, unbind=recorded):
        x, aux = run(lp, x, positions, enc_out)
        aux_total = aux_total + aux
    return x, aux_total


def _logits(params, cfg: ModelConfig, h):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return blk.einsum("bsd,dv->bsv", h, head).to(cfg.torch_dtype)


def _embed_inputs(params, cfg: ModelConfig, batch: dict):
    """The decoder stream's input (token embeddings, or ``embeds`` in
    embeds mode) and its positions: (B, S), or under M-RoPE
    ``batch["positions"]`` (3, B, S) where given, else the text positions
    0..S-1 on all three streams."""
    dt = cfg.torch_dtype
    if cfg.input_mode == "tokens":
        x = nn.embed_lookup(params["embed"], batch["tokens"]).to(dt)
    else:
        x = batch["embeds"].to(dt)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, None].expand(
                3, B, S)
    return x, positions


def _encdec_forward(params, cfg: ModelConfig, batch: dict):
    """Whisper: the encoder over ``enc_embeds`` (B, Se, d) plus sinusoidal
    positions, its final LayerNorm, then the decoder over the ``tokens``'
    embeddings plus sinusoidal positions, attending to the encoder's
    output.  Returns (the decoder's final hidden state, aux loss)."""
    dt = cfg.torch_dtype
    enc = batch["enc_embeds"].to(dt)
    B, Se = enc.shape[:2]
    dev = enc.device
    enc = enc + rope_mod.sinusoidal_positions(Se, cfg.d_model, dev).to(dt)
    x, positions = _embed_inputs(params, cfg, batch)
    x = x + rope_mod.sinusoidal_positions(x.shape[1], cfg.d_model,
                                          dev).to(dt)
    enc_positions = torch.arange(Se, device=dev)[None].expand(B, Se)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    enc_out = None
    for g, (kind, _) in zip(params["groups"], cfg.layer_groups()):
        if kind == "enc":
            enc, aux = _run_group(g, cfg, kind, enc, enc_positions)
            enc_out = _norm_apply(params["enc_final_norm"], enc,
                                  cfg.norm_eps)
        else:
            x, aux = _run_group(g, cfg, kind, x, positions, enc_out)
        aux_total = aux_total + aux
    return _norm_apply(params["final_norm"], x, cfg.norm_eps), aux_total


def forward(params, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor,
                                                             dict]:
    """Training/prefill forward pass.  batch: tokens (B, S) in tokens mode,
    embeds (B, S, d) in embeds mode, with positions (3, B, S) under M-RoPE
    (optional); enc_embeds (B, Se, d) and tokens (B, S) for an
    encoder-decoder model.  Returns (logits (B, S, Vp), aux dict):
    ``aux_loss``, and with ``cfg.mtp`` and tokens ``mtp_logits`` (B, S,
    Vp), DeepSeek-V3's multi-token prediction: one more layer over
    [norm(h_t); embed(token_{t+1})] projected to d, predicting token t + 2
    (the last position wraps round to the first token, as the
    reference's roll does)."""
    if cfg.family == "encdec":
        h, aux = _encdec_forward(params, cfg, batch)
        return _logits(params, cfg, h), dict(aux_loss=aux)
    x, positions = _embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g, (kind, _) in zip(params["groups"], cfg.layer_groups()):
        x, aux = _run_group(g, cfg, kind, x, positions)
        aux_total = aux_total + aux
    h = _norm_apply(params["final_norm"], x, cfg.norm_eps)
    out = dict(aux_loss=aux_total)
    if cfg.mtp and "tokens" in batch:
        dt, mtp = cfg.torch_dtype, params["mtp"]
        nxt = torch.roll(batch["tokens"], -1, dims=1)
        e2 = nn.embed_lookup(params["embed"], nxt).to(dt)
        hm = torch.cat([_norm_apply(mtp["norm"], x, cfg.norm_eps), e2],
                       dim=-1)
        hm = blk.einsum("bsd,de->bse", hm, mtp["proj"]).to(dt)
        hm, _ = layer_apply(mtp["block"], cfg, mtp_kind(cfg), hm, positions)
        hm = _norm_apply(params["final_norm"], hm, cfg.norm_eps)
        out["mtp_logits"] = _logits(params, cfg, hm)
    return _logits(params, cfg, h), out


def loss_fn(params, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor,
                                                             dict]:
    """Mean next-token cross-entropy over ``logits[..., :cfg.vocab]`` (the
    padded vocab tail masked out), under ``batch["mask"]`` where given,
    plus ``aux_loss_coef`` times the MoE load-balancing loss and, with
    multi-token prediction, ``mtp_weight`` times the cross-entropy of
    ``mtp_logits`` against the labels rolled one step left.  Returns
    (total, dict(ce=, aux=) and ``mtp=`` with multi-token prediction),
    float32 0-d tensors."""
    logits, out = forward(params, cfg, batch)
    labels, mask = batch["labels"], batch.get("mask")
    loss = nn.softmax_cross_entropy(logits[..., : cfg.vocab], labels, mask)
    total = loss + cfg.aux_loss_coef * out["aux_loss"]
    metrics = dict(ce=loss, aux=out["aux_loss"])
    if cfg.mtp and "mtp_logits" in out:
        mtp_loss = nn.softmax_cross_entropy(
            out["mtp_logits"][..., : cfg.vocab],
            torch.roll(labels, -1, dims=1), mask)
        total = total + cfg.mtp_weight * mtp_loss
        metrics["mtp"] = mtp_loss
    return total, metrics


# ---------------------------------------------------------------------------
# decode (serving) path
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                     device: str | torch.device = DEFAULT_DEVICE):
    dt, dev = cfg.torch_dtype, resolve_device(device)
    if kind == "enc":
        return None
    if kind == "dec":
        c = blk.init_attn_cache(cfg.attn_cfg(), batch, s_max, dt, dev)
        kv_shape = (batch, cfg.encoder_seq, cfg.kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(kv_shape, dtype=dt, device=dev)
        c["cross_v"] = torch.zeros(kv_shape, dtype=dt, device=dev)
        return c
    if kind == "jamba_period":
        return {f"l{i}": (
            blk.init_attn_cache(cfg.attn_cfg(), batch, s_max, dt, dev)
            if i == JAMBA_ATTN else blk.init_mamba_cache(cfg.mamba_cfg(),
                                                         batch, dt, dev))
            for i in range(JAMBA_PERIOD)}
    if kind == "rwkv":
        rc = cfg.rwkv_cfg()
        return dict(S=torch.zeros((batch, rc.n_heads, rc.head_dim,
                                   rc.head_dim), dtype=torch.float32,
                                  device=dev),
                    x_tm=torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                     device=dev),
                    x_cm=torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                     device=dev))
    if kind in ("mla_mlp", "mla_moe"):
        return blk.init_mla_cache(cfg.mla_cfg(), batch, s_max, dt, dev)
    if kind not in ("attn_mlp", "attn_moe"):
        raise ValueError(kind)
    return blk.init_attn_cache(cfg.attn_cfg(), batch, s_max, dt, dev)


def spec_layer_cache(cfg: ModelConfig, kind: str):
    """The logical axes of ``init_layer_cache``'s leaves (None for the
    encoder group, which has no cache)."""
    if kind in ("attn_mlp", "attn_moe"):
        return blk.spec_attn_cache(cfg.attn_cfg())
    if kind in ("mla_mlp", "mla_moe"):
        return blk.spec_mla_cache(cfg.mla_cfg())
    if kind == "rwkv":
        return dict(S=("batch", "heads", None, None),
                    x_tm=("batch", None, None), x_cm=("batch", None, None))
    if kind == "jamba_period":
        return {f"l{i}": (blk.spec_attn_cache(cfg.attn_cfg())
                          if i == JAMBA_ATTN
                          else blk.spec_mamba_cache(cfg.mamba_cfg()))
                for i in range(JAMBA_PERIOD)}
    if kind == "dec":
        s = blk.spec_attn_cache(cfg.attn_cfg())
        s["cross_k"] = ("batch", None, "kv", None)
        s["cross_v"] = ("batch", None, "kv", None)
        return s
    if kind == "enc":
        return None
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: str | torch.device = DEFAULT_DEVICE):
    """Zero decode caches per group, stacked (n, ...) with ``scan_layers``,
    else a list of per-layer dicts: k and v (B, s_max, KV, dh) per
    attention layer; c_kv (B, s_max, kv_lora_rank) and k_rope (B, s_max,
    qk_rope_dim) per MLA layer; S (B, H, dh, dh) float32, x_tm and x_cm
    (B, 1, d) per RWKV layer; per Jamba period one dict per sub-layer
    ``l0``..``l7``, Mamba's h (B, d_inner, d_state) float32 and conv (B,
    d_conv - 1, d_inner), the attention layer's k and v; per whisper
    decoder layer k and v and the cross-attention's cross_k and cross_v (B,
    encoder_seq, KV, dh), zeros that nothing fills (as in the reference:
    its prefill is decoder-only); None for the encoder group."""
    dev = resolve_device(device)
    caches = []
    for kind, n in cfg.layer_groups():
        if kind == "enc":
            caches.append(None)
        elif cfg.scan_layers:
            one = init_layer_cache(cfg, kind, batch, s_max, dev)
            caches.append(_tree_map(lambda a: a.new_zeros((n,) + a.shape),
                                    one))
        else:
            caches.append([init_layer_cache(cfg, kind, batch, s_max, dev)
                           for _ in range(n)])
    return caches


def cache_specs(cfg: ModelConfig) -> list:
    """The logical axes of ``init_cache``'s leaves: each group's stacked
    layer axis unnamed (None) with ``scan_layers``, as in the
    reference."""
    out = []
    for kind, n in cfg.layer_groups():
        s = spec_layer_cache(cfg, kind)
        if s is None:
            out.append(None)
        elif cfg.scan_layers:
            out.append(_stacked_spec(s, None))
        else:
            out.append([s] * n)
    return out


def layer_decode(params, cfg: ModelConfig, kind: str, x, cache, pos: int):
    """One token through one layer; writes the layer's cache in place.
    MLA decodes in the absorbed form, as the reference's does; a whisper
    decoder layer attends to its cache's cross_k and cross_v."""
    eps = cfg.norm_eps
    if kind == "dec":
        h = _norm_apply(params["norm1"], x, eps)
        h, _ = blk.attention_decode(params["attn"], cfg.attn_cfg(
            causal=True, use_rope=False), h, cache, pos)
        positions = torch.zeros((x.shape[0], 1), dtype=torch.int32,
                                device=x.device)
        x = _cross_ffn(params, cfg, x + h, positions,
                       (cache["cross_k"], cache["cross_v"]))
        return x, cache
    if kind == "jamba_period":
        for i in range(JAMBA_PERIOD):
            lp, lc = params[f"l{i}"], cache[f"l{i}"]
            h = _norm_apply(lp["norm1"], x, eps)
            if i == JAMBA_ATTN:
                h, _ = blk.attention_decode(lp["mixer"], cfg.attn_cfg(), h,
                                            lc, pos)
            else:
                h, new = blk.mamba_decode(lp["mixer"], cfg.mamba_cfg(), h,
                                          lc)
                lc["h"].copy_(new["h"])
                lc["conv"].copy_(new["conv"])
            x, _ = _jamba_ffn(lp, cfg, i, x + h)
        return x, cache
    if kind == "rwkv":
        rc = cfg.rwkv_cfg()
        h = _norm_apply(params["norm1"], x, eps)
        h_out, (x_tm, S) = blk.rwkv6_time_mix(params["tm"], rc, h,
                                              x_prev=cache["x_tm"],
                                              state=cache["S"],
                                              use_chunked=False)
        x = x + h_out
        h = _norm_apply(params["norm2"], x, eps)
        h_out, x_cm = blk.rwkv6_channel_mix(params["cm"], h,
                                            x_prev=cache["x_cm"])
        cache["S"].copy_(S)
        cache["x_tm"].copy_(x_tm)
        cache["x_cm"].copy_(x_cm)
        return x + h_out, cache
    if kind not in TRANSFORMER_KINDS:
        raise ValueError(kind)
    h = _norm_apply(params["norm1"], x, eps)
    if kind.startswith("attn"):
        h, cache = blk.attention_decode(params["attn"], cfg.attn_cfg(), h,
                                        cache, pos)
    else:
        h, cache = blk.mla_decode(params["attn"], cfg.mla_cfg(), h, cache,
                                  pos, absorbed=True)
    x = x + h
    h = _norm_apply(params["norm2"], x, eps)
    h, _ = _ffn_apply(params, cfg, kind, h)
    return x + h, cache


def decode_step(params, cfg: ModelConfig, caches, tokens, pos: int):
    """One decode step.  tokens: (B, 1) int (or embeds (B, 1, d) in embeds
    mode); pos: int position of the new token.  Updates ``caches`` in place
    (the new token's k/v, or MLA's c_kv and k_rope; RWKV's S, x_tm and
    x_cm; Mamba's h and conv).  An encoder-decoder model adds row ``pos``
    of the sinusoidal table (s_max rows, s_max read from the decoder
    cache) to the token's embedding and skips the encoder group.
    Returns (logits (B, 1, Vp), next_token
    (B, 1) int32, caches)."""
    dt = cfg.torch_dtype
    if cfg.input_mode == "tokens":
        x = nn.embed_lookup(params["embed"], tokens).to(dt)
    else:
        x = tokens.to(dt)
    if cfg.family == "encdec":
        k = caches[-1]["k"] if cfg.scan_layers else caches[-1][0]["k"]
        s_max = k.shape[2] if cfg.scan_layers else k.shape[1]
        x = x + rope_mod.sinusoidal_positions(
            s_max, cfg.d_model, x.device)[pos:pos + 1].to(dt)
    for g, cache, (kind, _) in zip(params["groups"], caches,
                                   cfg.layer_groups()):
        if kind == "enc":
            continue
        for lp, lc in zip(_layers(g, cfg), _layers(cache, cfg)):
            x, _ = layer_decode(lp, cfg, kind, x, lc, pos)
    h = _norm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, cfg, h)
    next_tok = torch.argmax(logits[..., : cfg.vocab], dim=-1).to(torch.int32)
    return logits, next_tok, caches


# ---------------------------------------------------------------------------
# cache-producing prefill (serving: prompt pass that hands off to decode)
# ---------------------------------------------------------------------------

def _pad_cache_seq(arr: torch.Tensor, s_max: int) -> torch.Tensor:
    pad = s_max - arr.shape[1]
    if pad <= 0:
        return arr[:, :s_max]
    return torch.cat([arr, arr.new_zeros((arr.shape[0], pad)
                                         + arr.shape[2:])], dim=1)


def layer_prefill(params, cfg: ModelConfig, kind: str, x, positions, s_max):
    """Full-sequence layer that also emits its decode cache.  GQA attention
    is plain ``ref.mha``, as in the reference (the flash kernel runs in
    ``forward`` only); MLA attends as ``mla_apply`` does, through the flash
    kernel under ``attn_core="flash"`` where S % 128 == 0, as in the
    reference, and caches c_kv and k_rope; RWKV's recurrence is sequential
    under the kernel core (``wkv_core="pallas"``, whose kernel keeps no
    state), as in the reference, and the chunked form otherwise where the
    length allows;
    Mamba runs its core (the CUDA kernel under ``mamba_core="pallas"``)
    and takes its final state from the plain scan, as in the reference."""
    eps = cfg.norm_eps
    dt = cfg.torch_dtype
    if kind == "jamba_period":
        caches = {}
        for i in range(JAMBA_PERIOD):
            lp = params[f"l{i}"]
            h = _norm_apply(lp["norm1"], x, eps)
            if i == JAMBA_ATTN:
                h, caches[f"l{i}"] = _attn_prefill(lp["mixer"], cfg, h,
                                                   positions, s_max)
            else:
                h, caches[f"l{i}"] = blk.mamba_apply(
                    lp["mixer"], cfg.mamba_cfg(), h, return_state=True)
            x, _ = _jamba_ffn(lp, cfg, i, x + h)
        return x, caches
    if kind == "rwkv":
        rc = cfg.rwkv_cfg()
        h = _norm_apply(params["norm1"], x, eps)
        h_out, (x_tm, S_state) = blk.rwkv6_time_mix(
            params["tm"], rc, h, use_chunked=(cfg.wkv_core != "pallas"))
        x = x + h_out
        h = _norm_apply(params["norm2"], x, eps)
        h_out, x_cm = blk.rwkv6_channel_mix(params["cm"], h)
        x = x + h_out
        return x, dict(S=S_state, x_tm=x_tm.to(dt), x_cm=x_cm.to(dt))
    if kind not in TRANSFORMER_KINDS:
        raise ValueError(f"prefill unsupported for kind {kind}")
    h = _norm_apply(params["norm1"], x, eps)
    if kind.startswith("attn"):
        h, cache = _attn_prefill(params["attn"], cfg, h, positions, s_max)
    else:
        h, cache = _mla_prefill(params["attn"], cfg, h, positions, s_max)
    x = x + h
    h = _norm_apply(params["norm2"], x, eps)
    h, _ = _ffn_apply(params, cfg, kind, h)
    return x + h, cache


def _attn_prefill(params, cfg: ModelConfig, h, positions, s_max):
    """Causal self-attention of the normed input ``h`` by plain ``ref.mha``
    (the flash kernel runs in ``forward`` only, as in the reference), and
    its k/v cache padded to ``s_max``."""
    B, S, _ = h.shape
    dt = cfg.torch_dtype
    q, k, v = blk._qkv(params, cfg.attn_cfg(), h, positions)
    o = kref.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=True)
    o = o.transpose(1, 2).reshape(B, S, -1)
    out = blk.einsum("bsh,hd->bsd", o, params["wo"]).to(h.dtype)
    return out, dict(k=_pad_cache_seq(k.to(dt), s_max),
                     v=_pad_cache_seq(v.to(dt), s_max))


def _mla_prefill(params, cfg: ModelConfig, h, positions, s_max):
    """MLA over the normed input ``h`` (``mla_apply``'s attention, the
    projections computed once), and its latent cache c_kv and k_rope
    padded to ``s_max``."""
    mcfg, dt = cfg.mla_cfg(), cfg.torch_dtype
    q_nope, q_rope, c_kv, k_rope = blk._mla_qkv(params, mcfg, h, positions)
    cache = dict(c_kv=_pad_cache_seq(c_kv.to(dt), s_max),
                 k_rope=_pad_cache_seq(k_rope[:, :, 0, :].to(dt), s_max))
    return blk._mla_attend(params, mcfg, h, q_nope, q_rope, c_kv,
                           k_rope), cache


def prefill(params, cfg: ModelConfig, batch: dict, s_max: int):
    """Prompt pass producing (logits, caches) for decode handoff.
    Decoder-only families (token or embeds mode); positions as in
    ``forward``."""
    assert cfg.family == "decoder"
    x, positions = _embed_inputs(params, cfg, batch)
    caches = []
    for g, (kind, _) in zip(params["groups"], cfg.layer_groups()):
        cache = []
        for lp in _layers(g, cfg):
            x, c = layer_prefill(lp, cfg, kind, x, positions, s_max)
            cache.append(c)
        caches.append(_stack(cache) if cfg.scan_layers else cache)
    h = _norm_apply(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, h), caches
