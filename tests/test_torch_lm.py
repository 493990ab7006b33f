"""The port's LM serving slice on the CPU, with torch and numpy only (no
JAX compile): InternLM2-1.8B's reduced config through init, forward with
each attention core, prefill and decode with in-place caches, serve_lm,
the flash wrapper's CPU contract and preconditions, the parameter carrier,
and that the port imports neither jax nor the reference.  Parity with the
reference is in tests/test_torch_jax_parity.py; the CUDA kernel is checked
on the card by tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve_lm as serve_mod
from repro_torch.layers import nn, rope
from repro_torch.models import lm
from repro_torch.train import steps
from repro_torch.weights import lm_from_jax_params

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2_1_8b"
CFG = configs.get_config(ARCH, reduced=True)


def _params(cfg=CFG, seed: int = 0):
    return lm.init_params(lm.make_generator(seed, "cpu"), cfg)


def _tokens(B: int, S: int, seed: int = 0, vocab: int = CFG.vocab):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(np.int32))


def _qkv(B, Hq, Hkv, Sq, Skv, d, dv=None, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, dv or d))
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            for s in shapes]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 30
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                (path, name)


def test_configs_registry():
    full = configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (24, 2048, 16, 8, 128,
                                                      8192, 92544)
    assert full.rope_theta == 1e6 and not full.tie_embeddings
    assert full.torch_dtype == torch.bfloat16 and full.padded_vocab == 92544
    assert configs.get_config("internlm2-1.8b", reduced=True) is CFG
    assert CFG.layer_groups() == [("attn_mlp", 3)]
    assert configs.canonical("qwen2.5-14b") == "qwen2_5_14b"
    for name in configs.ARCHS:
        full_name = configs.get_config(name).name
        assert configs.canonical(full_name) == name
        assert configs.get_config(name, reduced=True).name == (
            full_name + "-smoke")
    with pytest.raises(ValueError):
        configs.get_config("gpt5")
    assert configs.shape_applicable(full, "prefill_32k") == (True, "")
    ok, why = configs.shape_applicable(full, "long_500k")
    assert not ok and why


@pytest.mark.parametrize("change", tp.MODEL_CHANGES)
def test_unported_model_kinds_raise(change):
    """The config changes that reach whisper's encoder-decoder, its
    ``encoder_seq`` and qwen2-vl's M-RoPE (they raised while those were
    unported; the name is kept) now build: params and a decode cache
    (None for an encoder group, cross_k / cross_v of encoder_seq frames
    per decoder layer), a finite forward of the expected shape, and one
    decode step from the zero cache whose logits equal the forward's first
    position for a decoder-only model (1e-3).  Shared experts with
    InternLM2's d_ff_expert of 0 are (0, d) weights, whose LeCun scale
    divides by zero in both packages, so that case raises
    ZeroDivisionError as the reference does.  The reference's results are
    in tests/test_torch_jax_parity.py."""
    cfg = dataclasses.replace(CFG, **change)
    if cfg.n_shared_experts and not cfg.d_ff_expert:
        with pytest.raises(ZeroDivisionError):
            lm.init_params(lm.make_generator(0, "cpu"), cfg)
        return
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    caches = lm.init_cache(cfg, 2, 8, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in tp.model_change_batch(cfg, 2, 8, 1).items()}
    logits, aux = lm.forward(params, cfg, batch)
    assert logits.shape == (2, 8, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux["aux_loss"]))
    lg, tok, _ = lm.decode_step(params, cfg, caches, batch["tokens"][:, :1],
                                0)
    assert lg.shape == (2, 1, cfg.padded_vocab) and tok.shape == (2, 1)
    if cfg.family == "encdec":
        assert caches[0] is None
        assert caches[1]["cross_k"].shape[2] == cfg.encoder_seq
    else:
        tp.assert_close(logits[:, :1], lg, atol=1e-3, rtol=1e-3)


def test_layer_primitives_against_numpy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    tx = torch.from_numpy(x)
    want = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6) * scale
    tp.assert_close(want, nn.rms_norm(tx, torch.from_numpy(scale)))
    mu, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
    want = (x - mu) / np.sqrt(var + 1e-5) * scale + bias
    tp.assert_close(want, nn.layer_norm(tx, torch.from_numpy(scale),
                                        torch.from_numpy(bias)))
    assert nn.rms_norm(tx.bfloat16(), torch.from_numpy(scale)).dtype == \
        torch.bfloat16
    table = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    ids = torch.tensor([[3, 0], [9, 3]], dtype=torch.int32)
    assert torch.equal(nn.embed_lookup(table, ids)[1, 0], table[9])
    labels = torch.tensor([[1, 2, 0]])
    logits = torch.from_numpy(x[:1])
    lse = np.log(np.exp(x[0]).sum(-1))
    nll = lse - x[0, np.arange(3), [1, 2, 0]]
    tp.assert_close(nll.mean(), nn.softmax_cross_entropy(logits, labels))
    mask = torch.tensor([[1.0, 0.0, 1.0]])
    tp.assert_close((nll[0] + nll[2]) / 2,
                    nn.softmax_cross_entropy(logits, labels, mask))
    gen = torch.Generator().manual_seed(0)
    t = nn.trunc_normal(gen, (4000,), std=0.02)
    assert float(t.abs().max()) <= 0.04 and 0.015 < float(t.std()) < 0.02
    w = nn.lecun_normal(gen, (400, 300))
    assert abs(float(w.std()) - 400 ** -0.5) < 2e-3


def test_rope_rotates_halves_and_keeps_norms():
    """apply_rope rotates x[..., :D/2] against x[..., D/2:] (not even/odd
    pairs), one angle pos * theta^(-2i/D) per pair, so norms are kept and
    position 0 is the identity."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 2, 3, 8)).astype(np.float32))
    pos = torch.tensor([[0, 5]])
    y = rope.apply_rope(x, pos, theta=100.0)
    assert torch.equal(y[0, 0], x[0, 0])
    tp.assert_close(x.norm(dim=-1), y.norm(dim=-1))
    i = 1
    ang = 5 * 100.0 ** (-2 * i / 8)
    x1, x2 = x[0, 1, :, i], x[0, 1, :, 4 + i]
    tp.assert_close(x1 * np.cos(ang) - x2 * np.sin(ang), y[0, 1, :, i])
    tp.assert_close(x2 * np.cos(ang) + x1 * np.sin(ang), y[0, 1, :, 4 + i])


def test_init_params_shapes_dtype_and_seed():
    p = _params()
    d, H, KV, dh, F, n = 64, 4, 2, 16, 160, 3
    assert tuple(p["embed"].shape) == (256, d)
    assert tuple(p["lm_head"].shape) == (d, 256)
    g = p["groups"][0]
    assert tuple(g["attn"]["wq"].shape) == (n, d, H * dh)
    assert tuple(g["attn"]["wk"].shape) == (n, d, KV * dh)
    assert tuple(g["attn"]["wo"].shape) == (n, H * dh, d)
    assert tuple(g["ffn"]["w_gate"].shape) == (n, d, F)
    assert tuple(g["ffn"]["w_down"].shape) == (n, F, d)
    assert torch.equal(g["norm1"]["scale"], torch.ones((n, d)))
    assert not torch.equal(g["attn"]["wq"][0], g["attn"]["wq"][1])
    again, other = _params(), _params(seed=1)
    assert torch.equal(p["groups"][0]["ffn"]["w_up"],
                       again["groups"][0]["ffn"]["w_up"])
    assert not torch.equal(p["embed"], other["embed"])
    bf = _params(dataclasses.replace(CFG, dtype="bfloat16"))
    assert bf["groups"][0]["attn"]["wv"].dtype == torch.bfloat16
    listed = _params(dataclasses.replace(CFG, scan_layers=False))
    assert isinstance(listed["groups"][0], list)
    assert len(listed["groups"][0]) == n


@pytest.mark.parametrize("scan_layers", [True, False])
def test_forward_cores_and_prefill_decode_agree(scan_layers):
    """The flash core (S % 128 == 0: the flash wrapper's plain version on
    the CPU) equals the softmax core; at S = 96 the flash core falls back
    to softmax as in the reference; prefill then teacher-forced decode
    gives the forward's logits (the reference's own invariant)."""
    cfg = dataclasses.replace(CFG, scan_layers=scan_layers)
    p = _params(cfg)
    toks = _tokens(2, 128, seed=5)
    soft, aux = lm.forward(p, cfg, dict(tokens=toks))
    assert tuple(soft.shape) == (2, 128, 256) and soft.dtype == torch.float32
    flash_cfg = dataclasses.replace(cfg, attn_core="flash")
    flash = steps.make_prefill_step(flash_cfg)(p, dict(tokens=toks))
    tp.assert_close(soft, flash, atol=1e-5, rtol=1e-5)
    short = steps.make_prefill_step(flash_cfg)(p, dict(tokens=toks[:, :96]))
    assert torch.equal(short, lm.forward(p, cfg, dict(tokens=toks[:, :96]))[0])
    ident = lm.forward(p, dataclasses.replace(cfg, attn_core="identity"),
                       dict(tokens=toks))[0]
    assert ident.shape == soft.shape and torch.isfinite(ident).all()

    P, S = 100, 128
    logits, caches = lm.prefill(p, cfg, dict(tokens=toks[:, :P]), s_max=S)
    tp.assert_close(soft[:, :P], logits, atol=1e-5, rtol=1e-5)
    serve = steps.make_serve_step(cfg)
    for t in range(P, S):
        nxt, lg, caches = serve(p, caches, toks[:, t:t + 1], t)
        tp.assert_close(soft[:, t], lg[:, 0], atol=1e-5, rtol=1e-5)
        assert torch.equal(nxt[:, 0], lg[:, 0, :cfg.vocab].argmax(-1)
                           .to(torch.int32))


def test_decode_writes_caches_in_place_at_pos():
    p = _params()
    caches = lm.init_cache(CFG, 2, 10, device="cpu")
    k = caches[0]["k"]
    assert tuple(k.shape) == (3, 2, 10, 2, 16) and not k.any()
    toks = _tokens(2, 1, seed=6)
    logits, nxt, out = lm.decode_step(p, CFG, caches, toks, 4)
    assert out is caches and out[0]["k"] is k
    assert tuple(logits.shape) == (2, 1, 256) and nxt.dtype == torch.int32
    written = k.abs().sum(dim=(0, 1, 3, 4))
    assert written[4] > 0 and int((written > 0).sum()) == 1
    assert caches[0]["v"][:, :, 4].abs().sum() > 0
    listed = dataclasses.replace(CFG, scan_layers=False)
    lc = lm.init_cache(listed, 2, 10, device="cpu")
    assert isinstance(lc[0], list) and tuple(lc[0][0]["k"].shape) == (
        2, 10, 2, 16)


def test_pad_cache_seq_pads_and_truncates():
    a = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)
    padded = lm._pad_cache_seq(a, 5)
    assert tuple(padded.shape) == (2, 5, 2)
    assert torch.equal(padded[:, :3], a) and not padded[:, 3:].any()
    assert torch.equal(lm._pad_cache_seq(a, 2), a[:, :2])


@pytest.mark.parametrize("case", ["sq_blk", "skv_blk", "groups", "head_dim",
                                  "batch", "rank", "v_len"])
def test_flash_preconditions_raise(case):
    q, k, v = _qkv(1, 4, 2, 128, 128, 16)
    kw = {}
    if case == "sq_blk":
        q, k, v = _qkv(1, 4, 2, 200, 256, 16)        # 200 % 128
    elif case == "skv_blk":
        q, k, v = _qkv(1, 4, 2, 64, 192, 16)
        kw = dict(blk_q=64, blk_k=128)                # 192 % 128
    elif case == "groups":
        q, k, v = _qkv(1, 4, 3, 64, 64, 16)
    elif case == "head_dim":
        k = k[..., :8]
    elif case == "batch":
        k, v = torch.cat([k, k]), torch.cat([v, v])
    elif case == "rank":
        q = q[0]
    else:
        v = v[:, :, :64]
    before = fa.launches.value
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)
    assert fa.launches.value == before


def test_flash_cpu_runs_plain_without_launching():
    """CPU tensors run the plain version and launch nothing.  Its causal
    mask is aligned top left (the Pallas kernel's): it equals ref.mha when
    Sq == Skv or not causal, and differs from mha's bottom-right mask
    otherwise."""
    before = fa.launches.value
    q, k, v = _qkv(2, 4, 2, 128, 128, 16, dv=8)
    got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa.plain(q, k, v))
    tp.assert_close(ref.mha(q, k, v), got, atol=1e-6, rtol=1e-6)
    q, k, v = _qkv(1, 2, 2, 64, 256, 16, seed=1)
    assert torch.allclose(fa.flash_attention(q, k, v, causal=False),
                          ref.mha(q, k, v, causal=False), atol=1e-6)
    top_left = fa.flash_attention(q, k, v, causal=True)
    assert not torch.allclose(top_left, ref.mha(q, k, v, causal=True))
    # top left: query 0 sees key 0 alone, so its output is v's row 0
    tp.assert_close(v[:, :, 0], top_left[:, :, 0], atol=1e-6, rtol=1e-6)
    assert fa.launches.value == before


def test_flash_trainable_gradcheck_and_bf16():
    q, k, v = _qkv(1, 2, 1, 16, 16, 4, seed=2, dtype=torch.float64)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention_trainable(q, k, v, causal=True),
        leaves)
    q, k, v = _qkv(1, 2, 2, 128, 128, 32, seed=3, dtype=torch.bfloat16)
    out = fa.flash_attention(q, k, v, scale=0.1)
    assert out.dtype == torch.bfloat16
    want = ref.flash_attention(q.float(), k.float(), v.float(), scale=0.1)
    tp.assert_close(want, out.float(), atol=5e-2, rtol=5e-2)
    assert fa.flash_flops(1, 2, 128, 128, 32) == 2.0 * 128 * 128 * 32 * 2


def test_serve_lm_cpu_is_deterministic_and_in_range():
    a = serve_mod.serve_lm(ARCH, batch=2, prompt_len=8, gen=5, seed=3,
                           device="cpu", verbose=False)
    b = serve_mod.serve_lm(ARCH, batch=2, prompt_len=8, gen=5, seed=3,
                           device="cpu", verbose=False)
    assert a["tokens"].shape == (2, 5) and a["tokens"].dtype == np.int32
    assert ((a["tokens"] >= 0) & (a["tokens"] < CFG.vocab)).all()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["seconds"] > 0 and a["tokens_per_s"] > 0


def test_lm_from_jax_params_layouts_and_errors():
    p = _params()
    tree = lm._tree_map(lambda a: a.numpy(), p)
    got = lm_from_jax_params(tree, CFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(lm._leaves(got),
                                                 lm._leaves(p)))
    assert got["embed"].data_ptr() != p["embed"].data_ptr()
    listed = dataclasses.replace(CFG, scan_layers=False)
    per_layer = [lm._tree_map(lambda a, i=i: a[i], tree["groups"][0])
                 for i in range(3)]
    got = lm_from_jax_params(dict(tree, groups=[per_layer]), listed,
                             device="cpu")
    assert torch.equal(got["groups"][0][2]["attn"]["wq"],
                       p["groups"][0]["attn"]["wq"][2])
    bf = lm_from_jax_params(tree, dataclasses.replace(CFG, dtype="bfloat16"),
                            device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    bad = dict(tree)
    del bad["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        lm_from_jax_params(bad, CFG, device="cpu")
    bad = dict(tree, embed=tree["embed"][:10])
    with pytest.raises(ValueError, match="embed"):
        lm_from_jax_params(bad, CFG, device="cpu")
    bad = dict(tree, groups=[dict(tree["groups"][0], attn={})])
    with pytest.raises(ValueError, match="attn"):
        lm_from_jax_params(bad, CFG, device="cpu")


@pytest.mark.parametrize("entry", ["serve_lm", "make_generator",
                                   "init_cache", "lm_from_jax_params"])
def test_cuda_entry_points_raise_without_cuda(monkeypatch, entry):
    """Every entry point defaults to device="cuda" and raises where there
    is no CUDA device (no quiet move to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "serve_lm": lambda: serve_mod.serve_lm(ARCH, verbose=False),
        "make_generator": lambda: lm.make_generator(0),
        "init_cache": lambda: lm.init_cache(CFG, 1, 8),
        "lm_from_jax_params": lambda: lm_from_jax_params(
            lm._tree_map(lambda a: a.numpy(), _params()), CFG),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
    assert repro_torch.resolve_device("cpu").type == "cpu"
