"""The port's Qwen2-VL (M-RoPE) and Whisper (encoder-decoder) slice on the
CPU, with torch and numpy only (no JAX compile): the two configs at their
published sizes (on the meta device), apply_mrope's bands and its
reduction to RoPE, the sinusoidal table's layout, the ungated GELU FFN,
cross-attention through ``kv_override`` and the flash core's dispatch,
Qwen2-VL's prefill and decode against its forward, Whisper's forward,
decode from ``init_cache`` and remat, the parameter carrier's Whisper
leaves, ``launch/train.py`` on both, and two behaviours inherited from
the reference (ROADMAP section 3 faults 17 and 18).  Parity with the
reference is in tests/test_torch_jax_parity.py; the flash kernel at the
two models' shapes is checked on the card by tests/test_torch_cuda.py.
LM logits at the reference's 1e-3 (tests/test_models_smoke.py), layers at
float32 1e-5."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import pipeline as data_mod
from repro_torch.distributed import SimulatedCrash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve_lm as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.layers import rope
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.train import steps
from repro_torch.weights import _lm_layer_shapes, lm_from_jax_params

QWEN = "qwen2_vl_7b"
WHISPER = "whisper_large_v3"
LM_TOL = dict(atol=1e-3, rtol=1e-3)         # tests/test_models_smoke.py
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _params(cfg, seed: int = 0):
    return lm.init_params(lm.make_generator(seed, "cpu"), cfg)


def image_positions(B: int, text: int, rows: int, cols: int,
                    after: int) -> torch.Tensor:
    """data_mod.image_positions as a tensor."""
    return torch.from_numpy(data_mod.image_positions(B, text, rows, cols,
                                                     after))


def test_configs_at_published_sizes():
    """Both configs are ported FULL and REDUCED; the FULL widths are the
    published ones: Qwen2-VL-7B 28 layers, d 3584, GQA 28/4 at head_dim
    128, d_ff 18944, vocab 152064, QKV bias, M-RoPE sections (16, 24, 24),
    theta 1e6, 7.62 B parameters (15.23 GB in bf16); Whisper-large-v3 32
    encoder + 32 decoder layers, d 1280, 20 heads of 64, d_ff 5120, vocab
    51866 (51968 padded), 1500 encoder frames, tied embeddings, 1.54 B
    parameters (3.07 GB)."""
    q = configs.get_config(QWEN)
    assert (q.n_layers, q.d_model, q.n_heads, q.kv_heads, q.head_dim,
            q.d_ff, q.vocab) == (28, 3584, 28, 4, 128, 18944, 152064)
    assert q.qkv_bias and q.input_mode == "embeds" and q.rope_theta == 1e6
    assert q.mrope_sections == (16, 24, 24) and not q.tie_embeddings
    assert q.layer_groups() == [("attn_mlp", 28)]
    w = configs.get_config(WHISPER)
    assert (w.family, w.encoder_layers, w.n_layers, w.d_model, w.n_heads,
            w.kv_heads, w.head_dim, w.d_ff, w.vocab, w.padded_vocab,
            w.encoder_seq) == ("encdec", 32, 32, 1280, 20, 20, 64, 5120,
                               51866, 51968, 1500)
    assert w.tie_embeddings and w.qkv_bias and w.mrope_sections is None
    assert w.layer_groups() == [("enc", 32), ("dec", 32)]
    for name in (QWEN, WHISPER):
        r = configs.get_config(name.replace("_", "-"), reduced=True)
        assert r.dtype == "float32" and r.family == configs.get_config(
            name).family

    def meta(shapes):
        if isinstance(shapes, dict):
            return {k: meta(v) for k, v in shapes.items()}
        return torch.empty(tuple(shapes), device="meta")

    def count(cfg):
        n = sum(sum(a.numel() for a in lm._leaves(meta(_lm_layer_shapes(
            cfg, kind)))) * k for kind, k in cfg.layer_groups())
        heads = 1 if cfg.tie_embeddings else 2
        norms = 4 if cfg.family == "encdec" else 1  # scale (and bias) each
        return n + heads * cfg.padded_vocab * cfg.d_model + norms * cfg.d_model

    assert count(q) == 7_615_616_512
    assert count(w) == 1_535_308_800


def test_mrope_bands_and_reduction_to_rope():
    """apply_mrope at sections (2, 3, 3) / d 16 and (16, 24, 24) / d 128:
    three equal streams give apply_rope exactly; distinct streams rotate
    frequency band b by stream b (each band checked against apply_rope
    with that stream's positions); sections that do not sum to d / 2
    raise."""
    rng = np.random.default_rng(5)
    for sections, d in (((2, 3, 3), 16), ((16, 24, 24), 128)):
        x = torch.from_numpy(rng.standard_normal((2, 6, 3, d)).astype(
            np.float32))
        pos = torch.from_numpy(rng.integers(0, 5000, (3, 2, 6)))
        same = pos[:1].expand(3, 2, 6)
        assert torch.equal(rope.apply_mrope(x, same, sections, 1e6),
                           rope.apply_rope(x, pos[0], 1e6))
        got = rope.apply_mrope(x, pos, sections, 1e6)
        h = d // 2
        lo = 0
        for b, n in enumerate(sections):
            want = rope.apply_rope(x, pos[b], 1e6)
            for half in (0, h):
                sl = slice(half + lo, half + lo + n)
                torch.testing.assert_close(got[..., sl], want[..., sl],
                                           atol=0, rtol=0)
            lo += n
        assert not torch.allclose(got, rope.apply_rope(x, pos[0], 1e6))
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(x, pos, (16, 24, 23), 1e6)


def test_sinusoidal_table_interleaves_sin_and_cos():
    """sinusoidal_positions(n, d): row p has sin(p / 10000^(2i/d)) in
    column 2i and the cosine of the same angle in column 2i + 1, float32,
    within float32 rounding of the float64 formula (1500 frames at d 1280
    and 448 decoder positions)."""
    for n, d in ((1500, 1280), (448, 1280), (32, 64)):
        got = rope.sinusoidal_positions(n, d)
        assert got.dtype == torch.float32 and got.shape == (n, d)
        p = np.arange(n, dtype=np.float64)[:, None]
        ang = p / 10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d)
        want = np.empty((n, d))
        want[:, 0::2], want[:, 1::2] = np.sin(ang), np.cos(ang)
        # float32 angles at p < 1500 are within 1.2e-4 of the float64 ones
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
        assert torch.equal(got[0, 1::2], torch.ones(d // 2))
        assert torch.equal(got[0, 0::2], torch.zeros(d // 2))


def test_ungated_gelu_mlp():
    """init_mlp(gated=False) has w_up and w_down only; mlp_apply(gated=
    False) is gelu's tanh form (jax.nn.gelu's default) of x w_up, times
    w_down, against numpy; the gated form is unchanged."""
    gen = torch.Generator().manual_seed(3)
    p = blk.init_mlp(gen, 16, 40, gated=False)
    assert sorted(p) == ["w_down", "w_up"]
    assert sorted(blk.init_mlp(gen, 16, 40)) == ["w_down", "w_gate", "w_up"]
    x = torch.randn((2, 5, 16), generator=gen)
    u = x.double().numpy() @ p["w_up"].double().numpy()
    g = 0.5 * u * (1 + np.tanh(math.sqrt(2 / math.pi)
                               * (u + 0.044715 * u ** 3)))
    want = g @ p["w_down"].double().numpy()
    tp.assert_close(want, blk.mlp_apply(p, x, gated=False), **LAYER_TOL)
    erf = torch.nn.functional.gelu(x @ p["w_up"]) @ p["w_down"]
    assert not torch.allclose(erf, blk.mlp_apply(p, x, gated=False),
                              atol=1e-7, rtol=0)


def test_cross_attention_through_kv_override(monkeypatch):
    """attention_apply(kv_override=(k, v)): q from x, k and v the
    override's (Skv != S), non-causal plain attention, then wo, whatever
    the core; the flash core takes no kernel with an override, and
    "identity" averages the override's v."""
    cfg = blk.AttnConfig(d_model=32, n_heads=4, kv_heads=2, head_dim=8,
                         qkv_bias=True, causal=False, use_rope=False)
    gen = torch.Generator().manual_seed(4)
    p = blk.init_attention(gen, cfg)
    p = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
         for k, v in p.items()}
    x = torch.randn((2, 128, 32), generator=gen)
    k = torch.randn((2, 40, 2, 8), generator=gen)
    v = torch.randn((2, 40, 2, 8), generator=gen)
    pos = torch.arange(128)[None].expand(2, 128)
    q, _, _ = blk._qkv(p, cfg, x, pos)
    o = ref.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=False).transpose(1, 2).reshape(2, 128, 32)
    want = o @ p["wo"]
    calls = []
    monkeypatch.setattr(fa, "flash_attention_trainable",
                        lambda q, k, v, causal: calls.append(1) or fa.plain(
                            q, k, v, causal=causal))
    for core in ("softmax", "flash"):
        c = dataclasses.replace(cfg, attn_core=core)
        tp.assert_close(want, blk.attention_apply(p, c, x, pos,
                                                  kv_override=(k, v)),
                        **LAYER_TOL)
        causal = dataclasses.replace(c, causal=True)
        blk.attention_apply(p, causal, x, pos, kv_override=(k, v))
    assert calls == []
    blk.attention_apply(p, dataclasses.replace(cfg, attn_core="flash",
                                               causal=True), x, pos)
    assert calls == [1]
    ident = blk.attention_apply(p, dataclasses.replace(
        cfg, attn_core="identity"), x, pos, kv_override=(k, v))
    vm = v.mean(1, keepdim=True).repeat_interleave(2, dim=2)
    tp.assert_close(vm.expand(2, 128, 4, 8).reshape(2, 128, 32) @ p["wo"],
                    ident, **LAYER_TOL)


def test_qwen2_vl_prefill_and_decode_match_forward():
    """Qwen2-VL REDUCED (float32): the forward with an image's three
    distinct position streams differs from the text positions' forward;
    prefill of the image prompt equals its forward, and the default
    positions are the text ones on all three streams; with text positions,
    prefill of 12 tokens and teacher-forced decode_step to 16 equal the
    forward over 16 (the reference's 1e-3), and the flash core equals the
    softmax core at 128 tokens."""
    cfg = configs.get_config(QWEN, reduced=True)
    params = _params(cfg)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(
        np.float32))
    img = image_positions(2, 3, 2, 4, 5)
    assert img.shape == (3, 2, 16) and int(img.max()) == 11
    text = torch.arange(16)[None, None].expand(3, 2, 16)
    f_img, _ = lm.forward(params, cfg, dict(embeds=x, positions=img))
    f_txt, _ = lm.forward(params, cfg, dict(embeds=x, positions=text))
    f_def, _ = lm.forward(params, cfg, dict(embeds=x))
    assert torch.equal(f_txt, f_def)
    assert float((f_img - f_txt).abs().max()) > 1e-3
    lg, _ = lm.prefill(params, cfg, dict(embeds=x, positions=img), s_max=16)
    tp.assert_close(f_img, lg, **LM_TOL)
    P = 12
    lg, caches = lm.prefill(params, cfg, dict(embeds=x[:, :P]), s_max=16)
    tp.assert_close(f_txt[:, :P], lg, **LM_TOL)
    serve = steps.make_serve_step(cfg)
    for t in range(P, 16):
        _, lg, caches = serve(params, caches, x[:, t:t + 1], t)
        tp.assert_close(f_txt[:, t:t + 1], lg, **LM_TOL)
    x = torch.from_numpy(rng.standard_normal((1, 128, cfg.d_model)).astype(
        np.float32))
    pos = image_positions(1, 16, 8, 12, 16)
    soft, _ = lm.forward(params, cfg, dict(embeds=x, positions=pos))
    flash, _ = lm.forward(params, dataclasses.replace(cfg, attn_core="flash"),
                          dict(embeds=x, positions=pos))
    tp.assert_close(soft, flash, **LM_TOL)


def test_mrope_decode_takes_the_scalar_position_on_all_streams():
    """ROADMAP section 3 fault 17, kept from the reference: decode_step
    rotates the new token by its scalar ``pos`` on all three M-RoPE
    streams, so after an image prompt (largest position 11, at 16 tokens)
    the token at pos 16 is rotated as (16, 16, 16), where Qwen2-VL would
    continue from 12.  Its logits equal a forward whose last token has
    positions (16, 16, 16), not one with (12, 12, 12)."""
    cfg = configs.get_config(QWEN, reduced=True)
    params = _params(cfg, seed=1)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 17, cfg.d_model)).astype(
        np.float32))
    img = image_positions(2, 3, 2, 4, 5)
    _, caches = lm.prefill(params, cfg, dict(embeds=x[:, :16],
                                             positions=img), s_max=17)
    lg, _, _ = lm.decode_step(params, cfg, caches, x[:, 16:], 16)
    for nxt, match in ((16, True), (12, False)):
        pos = torch.cat([img, torch.full((3, 2, 1), nxt)], dim=2)
        f, _ = lm.forward(params, cfg, dict(embeds=x, positions=pos))
        assert torch.allclose(f[:, 16:], lg, **LM_TOL) == match, nxt


def _whisper_batch(cfg, B: int, S: int, seed: int) -> dict:
    """data_mod.stub_batch as tensors."""
    return {k: torch.from_numpy(v)
            for k, v in data_mod.stub_batch(cfg, B, S, seed).items()}


def test_whisper_forward_layers_and_caches():
    """Whisper REDUCED (float32): init_params has the biased final_norm,
    enc_final_norm and the enc/dec leaves the carrier expects (a
    round-trip through lm_from_jax_params is exact, stacked and as lists);
    forward equals the same stack run by hand (sinusoidal positions on
    both streams, the encoder, its final LayerNorm, the decoder with
    cross-attention) and depends on the encoder's frames; scan_layers
    False gives the same logits; init_cache has None for the encoder and
    k, v, cross_k, cross_v per decoder layer."""
    cfg = configs.get_config(WHISPER, reduced=True)
    params = _params(cfg)
    assert sorted(params) == ["embed", "enc_final_norm", "final_norm",
                              "groups"]
    assert sorted(params["final_norm"]) == ["bias", "scale"]
    enc, dec = params["groups"]
    assert sorted(dec) == ["attn", "cross", "ffn", "norm1", "norm2",
                           "norm3"]
    assert sorted(enc["ffn"]) == ["w_down", "w_up"]
    assert dec["cross"]["bk"].shape == (2, cfg.kv_heads * cfg.head_dim)
    tree = lm._tree_map(lambda a: a.numpy(), params)
    back = lm_from_jax_params(tree, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(lm._leaves(params),
                                                 lm._leaves(back)))
    batch = _whisper_batch(cfg, 2, 16, 8)
    got, aux = lm.forward(params, cfg, batch)
    assert got.shape == (2, 16, cfg.padded_vocab) and float(aux[
        "aux_loss"]) == 0.0

    eps, S = cfg.norm_eps, 16
    e = batch["enc_embeds"] + rope.sinusoidal_positions(cfg.encoder_seq,
                                                        cfg.d_model)
    epos = torch.arange(cfg.encoder_seq)[None].expand(2, -1)
    for lp in lm._layers(enc, cfg):
        e, _ = lm.layer_apply(lp, cfg, "enc", e, epos)
    e = lm._norm_apply(params["enc_final_norm"], e, eps)
    x = params["embed"][batch["tokens"].long()] + rope.sinusoidal_positions(
        S, cfg.d_model)
    pos = torch.arange(S)[None].expand(2, S)
    for lp in lm._layers(dec, cfg):
        x, _ = lm.layer_apply(lp, cfg, "dec", x, pos, e)
    want = lm._norm_apply(params["final_norm"], x, eps) @ params["embed"].T
    tp.assert_close(want, got, **LAYER_TOL)

    other = dict(batch, enc_embeds=batch["enc_embeds"].flip(1))
    assert float((lm.forward(params, cfg, other)[0] - got).abs().max()) > 1e-3
    unstacked = dataclasses.replace(cfg, scan_layers=False)
    lists = lm_from_jax_params(
        dict(tree, groups=[[lm._tree_map(lambda a, i=i: a[i], g)
                            for i in range(n)] for g, (_, n) in zip(
                                tree["groups"], cfg.layer_groups())]),
        unstacked, device="cpu")
    tp.assert_close(got, lm.forward(lists, unstacked, batch)[0],
                    **LAYER_TOL)
    caches = lm.init_cache(cfg, 2, 24, device="cpu")
    assert caches[0] is None and sorted(caches[1]) == [
        "cross_k", "cross_v", "k", "v"]
    assert caches[1]["cross_k"].shape == (2, 2, cfg.encoder_seq,
                                          cfg.kv_heads, cfg.head_dim)
    assert lm._leaves(caches[0]) == [] and lm._tree_map(
        lambda a: a, caches)[0] is None
    assert lm.init_cache(unstacked, 2, 24, device="cpu")[0] is None


def test_whisper_decode_from_init_cache():
    """decode_step from init_cache on Whisper REDUCED: the k/v written at
    each step are the decoder's self-attention k/v, and the logits of 4
    teacher-forced steps equal a forward whose decoder attends to an
    all-zero cross k/v (what an unfilled cache holds), at the
    reference's 1e-3; stacked and unstacked caches agree; the caches are
    written in place."""
    cfg = configs.get_config(WHISPER, reduced=True)
    params = _params(cfg, seed=2)
    batch = _whisper_batch(cfg, 2, 8, 9)
    S = 8
    zero = torch.zeros((2, cfg.encoder_seq, cfg.kv_heads, cfg.head_dim))
    x = params["embed"][batch["tokens"].long()] + rope.sinusoidal_positions(
        S, cfg.d_model)
    pos = torch.arange(S)[None].expand(2, S)
    for lp in lm._layers(params["groups"][1], cfg):
        h = lm._norm_apply(lp["norm1"], x, cfg.norm_eps)
        x = x + blk.attention_apply(lp["attn"], cfg.attn_cfg(
            use_rope=False), h, pos)
        x = lm._cross_ffn(lp, cfg, x, pos, (zero, zero))
    want = lm._norm_apply(params["final_norm"], x,
                          cfg.norm_eps) @ params["embed"].T
    caches = lm.init_cache(cfg, 2, S, device="cpu")
    k_before = caches[1]["k"]
    serve = steps.make_serve_step(cfg)
    for t in range(4):
        tok, lg, caches = serve(params, caches, batch["tokens"][:, t:t + 1],
                                t)
        tp.assert_close(want[:, t:t + 1], lg, **LM_TOL)
        assert tok.shape == (2, 1) and tok.dtype == torch.int32
    assert caches[1]["k"] is k_before and float(k_before[:, :, 3].abs()
                                                .max()) > 0
    assert float(k_before[:, :, 4:].abs().max()) == 0.0


def test_whisper_decode_never_sees_the_audio():
    """ROADMAP section 3 fault 18, kept from the reference: init_cache's
    cross_k and cross_v are zeros that nothing fills (lm.prefill refuses
    encoder-decoder models), so decode_step's logits do not depend on any
    encoder input, while the forward's do."""
    cfg = configs.get_config(WHISPER, reduced=True)
    params = _params(cfg, seed=3)
    with pytest.raises(AssertionError):
        lm.prefill(params, cfg, _whisper_batch(cfg, 1, 4, 1), s_max=8)
    outs = []
    for seed in (1, 2):
        batch = _whisper_batch(cfg, 1, 4, seed)
        caches = lm.init_cache(cfg, 1, 8, device="cpu")
        lg, _, _ = lm.decode_step(params, cfg, caches,
                                  batch["tokens"][:, :1] * 0, 0)
        outs.append((lg, lm.forward(params, cfg, dict(
            batch, tokens=batch["tokens"][:, :1] * 0))[0]))
        assert float(caches[1]["cross_k"].abs().max()) == 0.0
    assert torch.equal(outs[0][0], outs[1][0])
    assert float((outs[0][1] - outs[1][1]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", [QWEN, WHISPER])
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_gradients_reach_every_leaf(arch, remat):
    """lm.loss_fn on both REDUCED configs, under remat "none" and "dots"
    (torch.utils.checkpoint around each layer, the encoder's output an
    input of each decoder layer): equal losses and gradients at float32
    1e-5, and every parameter (the encoder's included, through the
    cross k/v) gets a nonzero gradient but Qwen2-VL's embedding table,
    which embeds mode never reads."""
    cfg = configs.get_config(arch, reduced=True)
    params = _params(cfg, seed=4)
    pipe = data_mod.pipeline_for(cfg, 16, 2, seed=5)
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch(0).items()}
    grads = {}
    for r in ("none", remat):
        leaves = [a.clone().requires_grad_() for a in lm._leaves(params)]
        loss, _ = lm.loss_fn(lm._unflatten(params, leaves),
                             dataclasses.replace(cfg, remat=r), batch)
        grads[r] = (loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
    tp.assert_close(grads["none"][0], grads[remat][0], **LAYER_TOL)
    n = len(grads["none"][1])
    unread = ({lm._unflatten(params, list(range(n)))["embed"]}
              if cfg.input_mode == "embeds" else set())
    for i, (a, b) in enumerate(zip(grads["none"][1], grads[remat][1])):
        tp.assert_close(a, b, **LAYER_TOL)
        assert (float(b.abs().max()) > 0) == (i not in unread), i


@pytest.mark.parametrize("arch", [QWEN, WHISPER])
def test_launch_train_runs_and_resumes(arch, tmp_path, monkeypatch):
    """launch/train.py on both REDUCED configs on the CPU (EmbedsPipeline
    batches: embeds with (3, B, S) positions, or encoder frames and
    tokens), accumulation 2: 12 finite losses near ln(vocab) (the labels
    are random); a run checkpointed every 4 steps and crashed before step
    8 resumes there and ends on the uninterrupted run's losses and params
    bit for bit."""
    kw = dict(steps=12, seq=16, global_batch=4, accum=2, lr=1e-3,
              ckpt_every=4, device="cpu", verbose=False)
    full = train_mod.train(arch, **kw)
    assert len(full["losses"]) == 12 and np.isfinite(full["losses"]).all()
    vocab = configs.get_config(arch, reduced=True).vocab
    assert np.allclose(full["losses"], np.log(vocab), atol=0.5)
    real = data_mod.EmbedsPipeline.batch

    def crash_at_8(self, step, shard=0):
        if step == 8:
            raise SimulatedCrash("crash before step 8")
        return real(self, step, shard)

    monkeypatch.setattr(data_mod.EmbedsPipeline, "batch", crash_at_8)
    with pytest.raises(SimulatedCrash):
        train_mod.train(arch, ckpt_dir=str(tmp_path), **kw)
    monkeypatch.setattr(data_mod.EmbedsPipeline, "batch", real)
    resumed = train_mod.train(arch, ckpt_dir=str(tmp_path), **kw)
    assert resumed["losses"] == full["losses"][8:]
    for a, b in zip(lm._leaves(full["params"]),
                    lm._leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_serve_lm_keeps_the_token_decoder_assertion():
    """serve_lm drives token-mode decoder models only, as the reference's
    examples/serve_lm.py does: Qwen2-VL (embeds) and Whisper (encoder-
    decoder) raise; their serving profile is the flash core."""
    for arch in (QWEN, WHISPER):
        cfg = configs.get_config(arch, reduced=True)
        assert serve_mod.serving_profile(cfg) == dict(attn_core="flash")
        with pytest.raises(AssertionError, match="token-mode decoder"):
            serve_mod.serve_lm(arch, device="cpu", verbose=False)
