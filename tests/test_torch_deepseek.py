"""The port's DeepSeek slice on the CPU, with torch and numpy only (no JAX
compile): the config registry (all ten configs ported), MLA's decode in
both forms against its full-sequence apply, the models' decode and prefill
against forward for the ``mla_*`` and ``attn_moe`` kinds, the MoE rule's
picks at DeepSeekMoE's and DeepSeek-V3's published expert counts, shared
experts, multi-token prediction, the parameter carrier's DeepSeek shapes,
the FULL configs' sizes on the meta device, the serving profile of every
family, and serve_lm on DeepSeek-V3 REDUCED. Parity with the reference is
in tests/test_torch_jax_parity.py; the flash kernel at MLA's head dims is
checked on the card by tests/test_torch_cuda.py. Tolerances are the
reference's: MLA decode at atol 2e-5 / rtol 1e-4 (tests/test_blocks.py), LM
logits at 1e-3 (tests/test_models_smoke.py)."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve_lm as serve_mod
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.train import steps
from repro_torch.weights import _lm_layer_shapes, lm_from_jax_params

MOE_ARCH = "deepseek_moe_16b"
V3_ARCH = "deepseek_v3_671b"
DEEPSEEK = (MOE_ARCH, V3_ARCH)
LM_TOL = dict(atol=1e-3, rtol=1e-3)         # tests/test_models_smoke.py
DECODE_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_blocks.py
MLA = blk.MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_dim=16)


def _params(cfg, seed: int = 0):
    return lm.init_params(lm.make_generator(seed, "cpu"), cfg)


def test_registry_ports_eight_configs_and_names_the_rest():
    """get_config returns all ten architectures, FULL and REDUCED (the
    name is kept from when two of them, qwen2-vl's M-RoPE and whisper's
    encoder-decoder, still raised), each of their layer kinds with the
    parameter carrier's shapes; the FULL widths of those two and of the
    five DeepSeek-slice configs are the published ones."""
    assert len(configs.ARCHS) == 10
    for name in configs.ARCHS:
        for reduced in (False, True):
            cfg = configs.get_config(name, reduced=reduced)
            assert isinstance(cfg, lm.ModelConfig)
            for kind, _ in cfg.layer_groups():
                _lm_layer_shapes(cfg, kind)
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.get_config("whisper_tiny")
    qwen = configs.get_config("qwen2-vl-7b")
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.kv_heads,
            qwen.head_dim, qwen.d_ff, qwen.vocab, qwen.mrope_sections,
            qwen.input_mode) == (28, 3584, 28, 4, 128, 18944, 152064,
                                 (16, 24, 24), "embeds")
    wh = configs.get_config("whisper-large-v3")
    assert (wh.family, wh.encoder_layers, wh.n_layers, wh.d_model,
            wh.n_heads, wh.head_dim, wh.d_ff, wh.vocab,
            wh.encoder_seq) == ("encdec", 32, 32, 1280, 20, 64, 5120,
                                51866, 1500)
    assert wh.layer_groups() == [("enc", 32), ("dec", 32)]
    moe = configs.get_config("deepseek-moe-16b")
    assert (moe.n_layers, moe.d_model, moe.n_heads, moe.head_dim, moe.d_ff,
            moe.n_experts, moe.top_k, moe.d_ff_expert, moe.n_shared_experts,
            moe.first_k_dense, moe.vocab) == (28, 2048, 16, 128, 10944, 64,
                                              6, 1408, 2, 1, 102400)
    assert moe.layer_groups() == [("attn_mlp", 1), ("attn_moe", 27)]
    v3 = configs.get_config(V3_ARCH)
    assert v3.layer_groups() == [("mla_mlp", 3), ("mla_moe", 58)]
    mc = v3.mla_cfg()
    assert (mc.n_heads, mc.q_lora_rank, mc.kv_lora_rank, mc.qk_dim,
            mc.v_dim) == (128, 1536, 512, 192, 128)
    assert v3.mtp and v3.mtp_weight == 0.3
    assert dataclasses.replace(v3, n_layers=4).layer_groups() == [
        ("mla_mlp", 3), ("mla_moe", 1)]
    for name, bias in (("qwen2_5_14b", True), ("codeqwen1_5_7b", True),
                       ("mistral_large_123b", False)):
        cfg = configs.get_config(name)
        assert cfg.qkv_bias == bias and cfg.layer_groups() == [
            ("attn_mlp", cfg.n_layers)]


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_decode_matches_apply(absorbed):
    """mla_decode step by step from zero caches (absorbed and expanded)
    against mla_apply over the whole sequence, at the reference's own
    2e-5 / 1e-4; the cache is written in place at each position and the
    rows past it stay zero."""
    gen = torch.Generator().manual_seed(3)
    p = blk.init_mla(gen, MLA)
    assert sorted(p) == ["kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a",
                         "wq_b"]
    rng = np.random.default_rng(4)
    S = 10
    x = torch.from_numpy(rng.standard_normal((2, S, 64)).astype(np.float32))
    pos = torch.arange(S)[None].expand(2, S)
    full = blk.mla_apply(p, MLA, x, pos)
    cache = blk.init_mla_cache(MLA, 2, S + 2, torch.float32,
                               torch.device("cpu"))
    c_kv = cache["c_kv"]
    ys = []
    for t in range(S):
        y, out = blk.mla_decode(p, MLA, x[:, t:t + 1], cache, t,
                                absorbed=absorbed)
        assert out is cache and out["c_kv"] is c_kv
        assert bool((cache["c_kv"][:, t + 1:] == 0).all())
        ys.append(y)
    tp.assert_close(full, torch.cat(ys, dim=1), **DECODE_TOL)
    _, _, c_want, k_want = blk._mla_qkv(p, MLA, x, pos)
    tp.assert_close(c_want, cache["c_kv"][:, :S], **DECODE_TOL)
    tp.assert_close(k_want[:, :, 0], cache["k_rope"][:, :S], **DECODE_TOL)


def test_mla_cores_follow_reference_conditions():
    """The flash core runs the flash kernel's function only where S % 128
    == 0 (here its plain version, no launch on the CPU) and equals the
    softmax core there; elsewhere it is the softmax core; "identity" is
    the mean of v on every position."""
    gen = torch.Generator().manual_seed(5)
    p = blk.init_mla(gen, MLA)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 128, 64)).astype(np.float32))
    pos = torch.arange(128)[None]
    soft = blk.mla_apply(p, MLA, x, pos)
    before = fa.launches.value
    flash_cfg = dataclasses.replace(MLA, attn_core="flash")
    tp.assert_close(soft, blk.mla_apply(p, flash_cfg, x, pos))
    tp.assert_close(soft[:, :40], blk.mla_apply(p, flash_cfg, x[:, :40],
                                                pos[:, :40]))
    assert fa.launches.value == before
    ident = blk.mla_apply(p, dataclasses.replace(MLA, attn_core="identity"),
                          x, pos)
    _, _, c_kv, _ = blk._mla_qkv(p, MLA, x, pos)
    _, v = blk._mla_expand_kv(p, MLA, c_kv)
    want = blk.einsum("bsh,hd->bsd", v.mean(1, keepdim=True).expand(
        1, 128, 4, 16).reshape(1, 128, 64), p["wo"])
    tp.assert_close(want, ident)


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_deepseek_prefill_and_decode_match_forward(arch):
    """DeepSeekMoE and DeepSeek-V3 REDUCED, float32: prefill of 20 tokens
    and teacher-forced decode_step (MLA in the absorbed form) to 32 give
    the forward's logits at 1e-3 (every MoE call here takes the dense path,
    which drops nothing); the caches are the init_cache's tensors, written
    in place; V3's forward returns mtp_logits and prefill does not run
    the MTP block."""
    cfg = configs.get_config(arch, reduced=True)
    params = _params(cfg)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    logits, aux = lm.forward(params, cfg, dict(tokens=toks))
    assert float(aux["aux_loss"]) > 0
    assert ("mtp_logits" in aux) == cfg.mtp
    P = 20
    assert blk.choose_moe_path(cfg.moe_cfg(), 2 * 32) == "dense"
    pre, caches = lm.prefill(params, cfg, dict(tokens=toks[:, :P]), s_max=32)
    tp.assert_close(logits[:, :P], pre, **LM_TOL)
    names = ("c_kv", "k_rope") if cfg.attn_type == "mla" else ("k", "v")
    zero = lm.init_cache(cfg, 2, 32, device="cpu")
    for c, z in zip(caches, zero):
        assert sorted(c) == sorted(z) == sorted(names)
        for n in names:
            assert c[n].shape == z[n].shape and c[n].dtype == z[n].dtype
            z[n].copy_(c[n])
    held = [z[n] for z in zero for n in names]
    for t in range(P, 32):
        lg, nxt, out = lm.decode_step(params, cfg, zero, toks[:, t:t + 1], t)
        assert out is zero and nxt.dtype == torch.int32
        tp.assert_close(logits[:, t:t + 1], lg, **LM_TOL)
    assert all(a is b for a, b in zip(held, [z[n] for z in zero
                                             for n in names]))


def test_moe_rule_picks_at_deepseek_widths():
    """choose_moe_path at the published expert counts: dense while E <=
    top_k + 0.5 + 1e4 / N, so up to 173 tokens for DeepSeekMoE (64 experts,
    top-6) and 40 for DeepSeek-V3 (256, top-8): a batch-4 decode step is
    dense (every expert on every token), a 4 x 1024 prefill sparse at
    capacity 480 and 160."""
    import math
    for arch, last_dense, C in ((MOE_ARCH, 173, 480), (V3_ARCH, 40, 160)):
        m = configs.get_config(arch).moe_cfg()
        assert [blk.choose_moe_path(m, n) for n in
                (4, last_dense, last_dense + 1, 4096)] == [
            "dense", "dense", "sparse", "sparse"]
        assert math.ceil(4096 * m.top_k / m.n_experts
                         * m.capacity_factor) == C
        assert m.n_shared == configs.get_config(arch).n_shared_experts
        assert m.d_ff_shared == m.n_shared * m.d_ff_expert


def test_shared_experts_add_a_dense_ffn():
    """moe_apply with shared experts is the routed output plus the shared
    FFN on every token, on both paths."""
    cfg = blk.MoEConfig(d_model=16, n_experts=8, top_k=2, d_ff_expert=8,
                        n_shared=2, d_ff_shared=16, capacity_factor=4.0)
    p = blk.init_moe(torch.Generator().manual_seed(8), cfg)
    assert tuple(p["shared"]["w_gate"].shape) == (16, 16)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 12, 16)).astype(np.float32))
    shared = blk.mlp_apply(p["shared"], x)
    for dispatch, fn in (("dense", blk.moe_apply_dense),
                         ("sparse", blk.moe_apply_sparse)):
        got, aux = blk.moe_apply(p, dataclasses.replace(
            cfg, dispatch=dispatch), x)
        routed, aux2 = fn(p, cfg, x.reshape(24, 16))
        tp.assert_close(routed.reshape(2, 12, 16) + shared, got)
        assert float(aux) == float(aux2)


def test_mtp_loss_adds_the_rolled_label_cross_entropy():
    """loss_fn with multi-token prediction: the total is ce + aux_loss_coef
    aux + mtp_weight mtp, the mtp metric the cross-entropy of mtp_logits
    against the labels rolled one left; without tokens in the batch the
    MTP block does not run."""
    from repro_torch.layers import nn
    cfg = configs.get_config(V3_ARCH, reduced=True)
    params = _params(cfg, seed=1)
    assert sorted(params["mtp"]) == ["block", "norm", "proj"]
    assert tuple(params["mtp"]["proj"].shape) == (2 * cfg.d_model,
                                                  cfg.d_model)
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (2, 17))
    batch = dict(tokens=torch.from_numpy(toks[:, :-1].astype(np.int32)),
                 labels=torch.from_numpy(toks[:, 1:].astype(np.int32)))
    total, m = lm.loss_fn(params, cfg, batch)
    assert sorted(m) == ["aux", "ce", "mtp"]
    _, out = lm.forward(params, cfg, batch)
    want = nn.softmax_cross_entropy(out["mtp_logits"][..., :cfg.vocab],
                                    torch.roll(batch["labels"], -1, 1))
    tp.assert_close(want, m["mtp"], atol=1e-6, rtol=1e-6)
    tp.assert_close(m["ce"] + cfg.aux_loss_coef * m["aux"]
                    + cfg.mtp_weight * m["mtp"], total, atol=1e-6, rtol=1e-6)
    embeds = nn.embed_lookup(params["embed"], batch["tokens"])
    _, out = lm.forward(params, dataclasses.replace(cfg, input_mode="embeds"),
                        dict(embeds=embeds))
    assert "mtp_logits" not in out


def test_lm_from_jax_params_takes_deepseek_trees():
    """The carrier's table matches init_params leaf for leaf at both
    DeepSeek REDUCED configs (the shared experts, MLA, the unstacked MTP
    block), keeps the router float32 in a bf16 model, and refuses a tree
    without the MTP block."""
    for arch in DEEPSEEK:
        cfg = configs.get_config(arch, reduced=True)
        p = _params(cfg)
        host = lm._tree_map(lambda a: a.numpy(), p)
        got = lm_from_jax_params(host, cfg, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(lm._leaves(p),
                                                     lm._leaves(got)))
        bf = lm_from_jax_params(host, dataclasses.replace(
            cfg, dtype="bfloat16"), device="cpu")
        moe = bf["groups"][-1]
        assert moe["ffn"]["router"].dtype == torch.float32
        assert moe["ffn"]["shared"]["w_up"].dtype == torch.bfloat16
        if cfg.mtp:
            assert bf["mtp"]["block"]["attn"]["wkv_b"].dtype == \
                torch.bfloat16
            with pytest.raises(ValueError, match="keys"):
                lm_from_jax_params({k: v for k, v in host.items()
                                    if k != "mtp"}, cfg, device="cpu")


def test_full_deepseek_sizes_on_the_meta_device():
    """DeepSeekMoE-16B FULL holds 16.38 B parameters (32.75 GB in bf16),
    DeepSeek-V3 cut to 4 layers (3 dense MLA layers, one MLA-MoE layer of
    256 experts, the MTP block) 15.80 B (31.59 GB): both fit one 80 GB
    card; the FULL 61 layers (671 B) do not."""
    def meta(shapes):
        if isinstance(shapes, dict):
            return {k: meta(v) for k, v in shapes.items()}
        return torch.empty(tuple(shapes), device="meta")

    def count(cfg):
        n = sum(sum(a.numel() for a in lm._leaves(meta(_lm_layer_shapes(
            cfg, kind)))) * k for kind, k in cfg.layer_groups())
        n += 2 * cfg.padded_vocab * cfg.d_model + cfg.d_model
        if cfg.mtp:
            n += cfg.d_model + 2 * cfg.d_model ** 2 + sum(
                a.numel() for a in lm._leaves(meta(_lm_layer_shapes(
                    cfg, lm.mtp_kind(cfg)))))
        return n

    assert count(configs.get_config(MOE_ARCH)) == 16_375_728_128
    v3 = configs.get_config(V3_ARCH)
    assert count(dataclasses.replace(v3, n_layers=4)) == 15_797_352_448
    assert count(v3) / 1e9 == pytest.approx(671.0, rel=0.02)


def test_serving_profile_is_flash_for_every_family_with_attention():
    """serving_profile: attn_core "flash" for every ported family but
    RWKV-6 (no attention), the recurrent kernel cores for Jamba and
    RWKV-6."""
    for name in configs.ARCHS:
        cfg = configs.get_config(name, reduced=True)
        prof = serve_mod.serving_profile(cfg)
        if cfg.layer_pattern == "rwkv":
            assert prof == dict(wkv_core="pallas")
        else:
            assert prof["attn_core"] == "flash"
            assert prof == dict(attn_core="flash", **(
                dict(mamba_core="pallas") if cfg.layer_pattern == "jamba"
                else {}))


def test_serve_lm_runs_deepseek_v3_reduced():
    """serve_lm on DeepSeek-V3 REDUCED on the CPU: the serving profile's
    flash core takes MLA's cache prefill through the flash kernel's
    function at 128 prompt tokens (its plain version here); tokens in
    range, and the same tokens as lm.prefill + decode_step under the
    softmax core from the same parameters."""
    cfg = configs.get_config(V3_ARCH, reduced=True)
    B, P, G = 2, 128, 4
    out = serve_mod.serve_lm(V3_ARCH, batch=B, prompt_len=P, gen=G, seed=2,
                             device="cpu", verbose=False)
    toks = out["tokens"]
    assert toks.shape == (B, G) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    params = _params(cfg, seed=2)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, P)).astype(np.int32))
    with torch.no_grad():
        lg, caches = lm.prefill(params, cfg, dict(tokens=prompts), P + G)
    nxt = torch.argmax(lg[:, -1:, :cfg.vocab], -1).to(torch.int32)
    want = []
    serve = steps.make_serve_step(cfg)
    for t in range(P, P + G):
        want.append(nxt)
        nxt, _, caches = serve(params, caches, nxt, t)
    np.testing.assert_array_equal(toks, torch.cat(want, 1).numpy())
