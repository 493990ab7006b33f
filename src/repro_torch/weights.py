"""Carry model parameters over from the JAX reference: the GNN layers
(``from_jax_params``), the LM pytree (``lm_from_jax_params``) and its
AdamW state (``adamw_state_from_jax``); and the LM's shape tree as meta
tensors (``lm_meta_params``, what ``launch/specs.py`` traces against).

``jax.random`` and torch generators give different numbers from one seed,
so a comparison of the two packages starts both from the reference's
parameters, converted to numpy by the caller.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device


# the key set of each model's layer: GCN, SAGE, GIN, GAT
LAYER_KEYS = ({"w", "b"}, {"w_self", "w_neigh", "b"},
              {"eps", "w1", "b1", "w2", "b2"}, {"w", "a_dst", "a_src", "b"})


def _check_gnn_layer(i: int, arrs: dict) -> None:
    """Each weight is (in, out) with its bias (out,); GIN's ``eps`` is a
    scalar and its two weights chain (w1's out is w2's in); GAT's
    attention vectors ``a_dst`` and ``a_src`` are (out,)."""
    for a in ("a_dst", "a_src"):
        if a in arrs and arrs[a].shape != arrs["b"].shape:
            raise ValueError(f"layer {i}: {a} {arrs[a].shape} is not "
                             f"(out,) = {arrs['b'].shape}")
    if "eps" in arrs:
        pairs = (("w1", "b1"), ("w2", "b2"))
        if arrs["eps"].shape != ():
            raise ValueError(f"layer {i}: eps {arrs['eps'].shape} is not "
                             "a scalar ()")
    else:
        pairs = tuple((k, "b") for k in arrs
                      if k not in ("b", "a_dst", "a_src"))
    for w, b in pairs:
        a, bias = arrs[w], arrs[b]
        if a.ndim != 2 or bias.shape != (a.shape[1],):
            raise ValueError(f"layer {i}: {w} {a.shape} and {b} "
                             f"{bias.shape} are not (in, out) and (out,)")
    if "w_self" in arrs and arrs["w_self"].shape != arrs["w_neigh"].shape:
        raise ValueError(f"layer {i}: w_self {arrs['w_self'].shape} and "
                         f"w_neigh {arrs['w_neigh'].shape} differ")
    if "w1" in arrs and arrs["w1"].shape[1] != arrs["w2"].shape[0]:
        raise ValueError(f"layer {i}: w1 {arrs['w1'].shape} and w2 "
                         f"{arrs['w2'].shape} do not chain")


def from_jax_params(params_np: Sequence[Mapping[str, np.ndarray]],
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> list[dict[str, torch.Tensor]]:
    """Parameters of ``repro.core.gnn.init_model`` (one dict per layer, as
    numpy: GCN's ``w`` (in, out) and ``b`` (out,); SAGE's ``w_self`` and
    ``w_neigh`` (in, out) and ``b`` (out,); GIN's ``eps`` (), ``w1``
    (in, hidden), ``b1`` (hidden,), ``w2`` (hidden, out) and ``b2``
    (out,); or GAT's ``w`` (in, out), ``a_dst``, ``a_src`` and ``b``
    (out,)) as this package's parameters: float32 tensors of the same
    shapes on ``device``, each with storage of its own (never the caller's
    arrays).  The result can start ``repro_torch.core.gnn.train(params=
    ...)`` directly, which copies it and writes into nothing it was
    given."""
    dev = resolve_device(device)
    out = []
    for i, layer in enumerate(params_np):
        if set(layer) not in LAYER_KEYS:
            raise ValueError(f"layer {i}: expected GCN keys {{'w', 'b'}}, "
                             "SAGE keys {'w_self', 'w_neigh', 'b'}, GIN "
                             "keys {'eps', 'w1', 'b1', 'w2', 'b2'} or GAT "
                             "keys {'w', 'a_dst', 'a_src', 'b'}, got "
                             f"{sorted(layer)}")
        arrs = {k: np.asarray(v, np.float32) for k, v in layer.items()}
        _check_gnn_layer(i, arrs)
        out.append({k: torch.from_numpy(a.copy()).to(dev)
                    for k, a in arrs.items()})
    return out


class _Float32(tuple):
    """A leaf's shape whose tensor stays float32 whatever the model dtype
    (RWKV-6's ``u`` and ``w0``, Mamba's ``A_log`` and ``D``, the MoE
    router, as the reference keeps them)."""


def _attn_shapes(cfg) -> dict:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    attn = dict(wq=(d, H * dh), wk=(d, KV * dh), wv=(d, KV * dh),
                wo=(H * dh, d))
    if cfg.qkv_bias:
        attn.update(bq=(H * dh,), bk=(KV * dh,), bv=(KV * dh,))
    return attn


def _mlp_shapes(d: int, f: int, gated: bool = True) -> dict:
    out = dict(w_up=(d, f), w_down=(f, d))
    if gated:
        out["w_gate"] = (d, f)
    return out


def _norm_shapes(d: int, with_bias: bool = False) -> dict:
    return dict(scale=(d,), bias=(d,)) if with_bias else dict(scale=(d,))


def _mla_shapes(cfg) -> dict:
    mc, d = cfg.mla_cfg(), cfg.d_model
    H, r, kv = mc.n_heads, mc.q_lora_rank, mc.kv_lora_rank
    return dict(wq_a=(d, r), q_norm=(r,), wq_b=(r, H * mc.qk_dim),
                wkv_a=(d, kv + mc.qk_rope_dim), kv_norm=(kv,),
                wkv_b=(kv, H * (mc.qk_nope_dim + mc.v_dim)),
                wo=(H * mc.v_dim, d))


def _moe_shapes(cfg) -> dict:
    """The routed experts stacked on axis 0, the float32 router and, with
    shared experts, their FFN ``shared``."""
    moe, d = cfg.moe_cfg(), cfg.d_model
    E, f = moe.n_experts, moe.d_ff_expert
    out = dict(router=_Float32((d, E)), w_gate=(E, d, f), w_up=(E, d, f),
               w_down=(E, f, d))
    if moe.n_shared:
        out["shared"] = _mlp_shapes(d, moe.d_ff_shared)
    return out


def _jamba_period_shapes(cfg) -> dict:
    """The 8 sub-layers ``l0``..``l7`` of a ``jamba_period``."""
    from repro_torch.models import lm
    d = cfg.d_model
    mc = cfg.mamba_cfg()
    di, ds, r = mc.d_inner, mc.d_state, mc.rank
    mamba = dict(in_proj=(d, 2 * di), conv_w=(mc.d_conv, di), conv_b=(di,),
                 x_proj=(di, r + 2 * ds), dt_proj=(r, di), dt_bias=(di,),
                 A_log=_Float32((di, ds)), D=_Float32((di,)),
                 out_proj=(di, d))
    experts = _moe_shapes(cfg)
    return {f"l{i}": dict(
        norm1=dict(scale=(d,)), norm2=dict(scale=(d,)),
        mixer=_attn_shapes(cfg) if i == lm.JAMBA_ATTN else mamba,
        ffn=experts if i % 2 else _mlp_shapes(d, cfg.d_ff))
        for i in range(lm.JAMBA_PERIOD)}


def _lm_layer_shapes(cfg, kind: str) -> dict:
    """Shape of every leaf of one layer of ``kind`` (``attn_mlp``,
    ``attn_moe``, ``mla_mlp``, ``mla_moe``, ``rwkv``, ``jamba_period``, or
    whisper's ``enc`` and ``dec``: biased LayerNorms, attention (and the
    decoder's cross-attention) with their QKV biases, the ungated FFN) of
    ``cfg``."""
    d = cfg.d_model
    if kind in ("enc", "dec"):
        norms = ("norm1", "norm2") + (("norm3",) if kind == "dec" else ())
        out = {n: _norm_shapes(d, with_bias=True) for n in norms}
        out["attn"] = _attn_shapes(cfg)
        if kind == "dec":
            out["cross"] = _attn_shapes(cfg)
        out["ffn"] = _mlp_shapes(d, cfg.d_ff, gated=False)
        return out
    if kind == "jamba_period":
        return _jamba_period_shapes(cfg)
    if kind == "rwkv":
        rc = cfg.rwkv_cfg()
        H, dh, ff = rc.n_heads, rc.head_dim, rc.d_ff or int(3.5 * d)
        tm = {f"mu_{c}": (d,) for c in "rkvwg"}
        tm.update(wr=(d, d), wk=(d, d), wv=(d, d), wg=(d, d),
                  w0=_Float32((d,)), w_lora_a=(d, rc.lora_rank),
                  w_lora_b=(rc.lora_rank, d), u=_Float32((H, dh)),
                  ln_x=(d,), wo=(d, d))
        return dict(norm1=dict(scale=(d,)), norm2=dict(scale=(d,)), tm=tm,
                    cm=dict(mu_k=(d,), mu_r=(d,), wk=(d, ff), wv=(ff, d),
                            wr=(d, d)))
    mixer, ffn = kind.split("_")
    return dict(norm1=dict(scale=(d,)), norm2=dict(scale=(d,)),
                attn=_attn_shapes(cfg) if mixer == "attn" else
                _mla_shapes(cfg),
                ffn=_mlp_shapes(d, cfg.d_ff) if ffn == "mlp" else
                _moe_shapes(cfg))


def _lm_top_shapes(cfg) -> dict:
    """Shape of every leaf of the LM's params outside its layer groups:
    embed, the untied head, the final norm (biased in an encoder-decoder
    model, which has ``enc_final_norm`` too) and with ``cfg.mtp`` the
    multi-token prediction block."""
    from repro_torch.models import lm
    V, d = cfg.padded_vocab, cfg.d_model
    encdec = cfg.family == "encdec"
    top = dict(embed=(V, d), final_norm=_norm_shapes(d, with_bias=encdec))
    if not cfg.tie_embeddings:
        top["lm_head"] = (d, V)
    if encdec:
        top["enc_final_norm"] = _norm_shapes(d, with_bias=True)
    if cfg.mtp:
        top["mtp"] = dict(norm=dict(scale=(d,)), proj=(2 * d, d),
                          block=_lm_layer_shapes(cfg, lm.mtp_kind(cfg)))
    return top


def lm_meta_params(cfg) -> dict:
    """``lm.init_params(cfg)``'s tree as meta tensors (shapes and dtypes,
    no storage): ``cfg``'s dtype, float32 where the reference keeps it
    (RWKV-6's ``u`` and ``w0``, Mamba's ``A_log`` and ``D``, the MoE
    router); each group stacked (n, ...) with ``scan_layers``, else a list
    of its n layers."""
    dt = cfg.torch_dtype

    def meta(shapes, lead=()):
        if isinstance(shapes, dict):
            return {k: meta(v, lead) for k, v in shapes.items()}
        return torch.empty(lead + tuple(shapes), device="meta", dtype=(
            torch.float32 if isinstance(shapes, _Float32) else dt))

    out = meta(_lm_top_shapes(cfg))
    out["groups"] = [
        meta(_lm_layer_shapes(cfg, kind), (n,)) if cfg.scan_layers
        else [meta(_lm_layer_shapes(cfg, kind)) for _ in range(n)]
        for kind, n in cfg.layer_groups()]
    return out


def _convert(tree, shapes, where: str, dtype, dev, lead=()):
    """``tree`` (numpy leaves) as tensors of ``dtype`` (float32 where the
    shape is ``_Float32``) on ``dev``, checked leaf by leaf against
    ``shapes`` (with ``lead`` dims in front)."""
    if isinstance(shapes, dict):
        if not isinstance(tree, Mapping) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree)
            raise ValueError(f"{where}: expected keys {sorted(shapes)}, "
                             f"got {got}")
        return {k: _convert(tree[k], shapes[k], f"{where}.{k}", dtype, dev,
                            lead) for k in shapes}
    a = np.asarray(tree)
    if a.shape != lead + tuple(shapes):
        raise ValueError(f"{where}: expected shape {lead + tuple(shapes)}, "
                         f"got {a.shape}")
    # float32 on the way: numpy has no bfloat16 of its own
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        device=dev,
        dtype=torch.float32 if isinstance(shapes, _Float32) else dtype)


def lm_from_jax_params(params_np: Mapping, cfg,
                       device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The reference's ``repro.models.lm.init_params`` pytree for ``cfg``
    (leaves as numpy; with ``cfg.scan_layers`` each group's layers stacked
    on axis 0, else a list of layers) as this package's parameters: the
    same tree of tensors in ``cfg``'s dtype (RWKV-6's ``u`` and ``w0``,
    Mamba's ``A_log`` and ``D`` and the MoE router in float32, as the
    reference keeps them) on ``device``, each with storage of its own.
    Layer kinds ``attn_mlp``, ``attn_moe``, ``mla_mlp``, ``mla_moe``,
    ``rwkv``, ``jamba_period``, ``enc`` and ``dec``; with ``cfg.mtp`` the
    ``mtp`` subtree (norm, proj and one layer, not stacked); for an
    encoder-decoder model the biased ``final_norm`` and
    ``enc_final_norm``."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    top = _lm_top_shapes(cfg)
    if set(params_np) != set(top) | {"groups"}:
        raise ValueError(f"expected keys {sorted(set(top) | {'groups'})}, "
                         f"got {sorted(params_np)}")
    out = {k: _convert(params_np[k], s, k, dt, dev) for k, s in top.items()}
    groups = params_np["groups"]
    if len(groups) != len(cfg.layer_groups()):
        raise ValueError(f"expected {len(cfg.layer_groups())} layer groups, "
                         f"got {len(groups)}")
    out["groups"] = []
    for gi, (g, (kind, n)) in enumerate(zip(groups, cfg.layer_groups())):
        where = f"groups[{gi}]"
        layer = _lm_layer_shapes(cfg, kind)
        if cfg.scan_layers:
            out["groups"].append(_convert(g, layer, where, dt, dev, (n,)))
        else:
            if len(g) != n:
                raise ValueError(f"{where}: expected {n} layers, got {len(g)}")
            out["groups"].append([_convert(lp, layer, f"{where}[{i}]", dt,
                                           dev) for i, lp in enumerate(g)])
    return out


def _like_tree(tree_np, like, where: str, dev) -> Any:
    """``tree_np`` (numpy leaves) as float32 tensors on ``dev`` in the
    structure of ``like`` (a params tree), shapes checked leaf by leaf."""
    if isinstance(like, Mapping):
        if not isinstance(tree_np, Mapping) or set(tree_np) != set(like):
            got = (sorted(tree_np) if isinstance(tree_np, Mapping)
                   else type(tree_np))
            raise ValueError(f"{where}: expected keys {sorted(like)}, got "
                             f"{got}")
        return {k: _like_tree(tree_np[k], like[k], f"{where}.{k}", dev)
                for k in like}
    if isinstance(like, (list, tuple)):
        if len(tree_np) != len(like):
            raise ValueError(f"{where}: expected {len(like)} entries, got "
                             f"{len(tree_np)}")
        return type(like)(_like_tree(t, l, f"{where}[{i}]", dev)
                          for i, (t, l) in enumerate(zip(tree_np, like)))
    a = np.asarray(tree_np, np.float32)
    if a.shape != tuple(like.shape):
        raise ValueError(f"{where}: expected shape {tuple(like.shape)}, got "
                         f"{a.shape}")
    return torch.from_numpy(a.copy()).to(dev)


def adamw_state_from_jax(opt_state_np: Mapping, params,
                         device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The reference's ``repro.optim.adamw`` state (``m``, ``v``, ``step``,
    and the error feedback ``ef`` where gradient compression carries one;
    leaves as numpy) for this package's ``params`` (``lm_from_jax_params``'s
    tree): ``m``, ``v`` (and ``ef``) as float32 tensors in the structure of
    ``params`` on ``device``, ``step`` a 0-d int32 tensor there, so that a
    run of ``train.steps.make_train_step`` continues the reference's."""
    dev = resolve_device(device)
    keys = set(opt_state_np)
    if not {"m", "v", "step"} <= keys <= {"m", "v", "step", "ef"}:
        raise ValueError("expected keys m, v, step (and ef), got "
                         f"{sorted(keys)}")
    out = {k: _like_tree(opt_state_np[k], params, k, dev)
           for k in ("m", "v", "ef") if opt_state_np.get(k) is not None}
    step = np.asarray(opt_state_np["step"])
    if step.shape != ():
        raise ValueError(f"step: expected a scalar, got shape {step.shape}")
    out["step"] = torch.tensor(int(step), dtype=torch.int32, device=dev)
    return out
