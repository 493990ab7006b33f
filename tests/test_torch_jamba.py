"""The port's Jamba slice on the CPU, with torch and numpy only (no JAX
compile): the Mamba scan's plain version against the plain associative
scan (the "xla" core), the kernel wrapper's CPU contract and
preconditions, the MoE dense-or-sparse rule and its capacity drops,
Jamba-v0.1's reduced config through forward, prefill, decode (in-place
caches) and serve_lm, the parameter carrier's float32 leaves, the FULL
config's size on the meta device, and init_params' stacking.  Parity with
the reference is in tests/test_torch_jax_parity.py; the CUDA kernel is
checked on the card by tests/test_torch_cuda.py.  Tolerances are the
reference's: the scan at float32 atol = rtol = 1e-4
(tests/test_kernels_mamba.py), LM logits at 1e-3
(tests/test_models_smoke.py)."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref
from repro_torch.launch import serve_lm as serve_mod
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.train import steps
from repro_torch.weights import _lm_layer_shapes, lm_from_jax_params

ARCH = "jamba_v0_1_52b"
CFG = configs.get_config(ARCH, reduced=True)
PROFILE = dict(mamba_core="pallas", attn_core="flash")
LM_TOL = dict(atol=1e-3, rtol=1e-3)         # tests/test_models_smoke.py
# tests/test_kernels_mamba.py's (B, T, d_inner, d_state, chunk, d_tile)
SHAPES = [(1, 16, 8, 2, 8, 8), (2, 64, 32, 4, 16, 16),
          (1, 128, 64, 8, 32, 32), (2, 32, 16, 16, 32, 8)]


def make_inputs(seed, B, T, di, ds, dt_scale=0.1):
    """tests/test_kernels_mamba.py's make_inputs, from numpy: x, dt, Bc,
    Cc, A, D (the wrapper's argument order)."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, T, di)),
            np.abs(rng.standard_normal((B, T, di))) * dt_scale,
            rng.standard_normal((B, T, ds)), rng.standard_normal((B, T, ds)),
            -(np.abs(rng.standard_normal((di, ds))) + 0.1),
            rng.standard_normal((di,)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


def _params(cfg=CFG, seed: int = 0):
    return lm.init_params(lm.make_generator(seed, "cpu"), cfg)


def _tokens(B: int, S: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, CFG.vocab, (B, S))
                            .astype(np.int32))


@pytest.mark.parametrize("B,T,di,ds,chunk,d_tile", SHAPES)
def test_plain_scan_matches_sequential_oracle(B, T, di, ds, chunk, d_tile):
    """ref.mamba_ssm (the kernel's plain version, sequential) against the
    plain associative scan of the "xla" core, and the wrapper's CPU
    result; the recurrence's final state is the scan's last."""
    x, dt, Bc, Cc, A, D = make_inputs(B + T, B, T, di, ds)
    want = ref.mamba_ssm(x, dt, A, Bc, Cc, D)
    hs = blk._mamba_states(dt, x, Bc, A)
    y = torch.einsum("btds,bts->btd", hs, Cc) + x * D
    tp.assert_close(want, y)
    got = ms.mamba_scan(x, dt, Bc, Cc, A, D, chunk=chunk, d_tile=d_tile)
    assert torch.equal(got, want)
    y_rec, h = ref.mamba_recurrence(x, dt, A, Bc, Cc, D)
    assert torch.equal(y_rec, want) and h.dtype == torch.float32
    tp.assert_close(hs[:, -1], h)


def test_kernel_cpu_runs_plain_without_launching():
    """CPU tensors run the plain version and launch nothing; y keeps x's
    dtype; with large dt (every exp(dt A) near 0) the result stays finite
    and equals the oracle."""
    before = ms.launches.value
    args = make_inputs(1, 2, 32, 16, 4)
    assert ms.plain is ref.mamba_ssm
    got = ms.mamba_scan(*args)
    x, dt, Bc, Cc, A, D = args
    assert torch.equal(got, ref.mamba_ssm(x, dt, A, Bc, Cc, D))
    out = ms.mamba_scan(x.bfloat16(), *args[1:])
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    big = make_inputs(2, 1, 64, 8, 4, dt_scale=30.0)
    y = ms.mamba_scan(*big)
    x, dt, Bc, Cc, A, D = big
    assert torch.isfinite(y).all()
    tp.assert_close(ref.mamba_ssm(*(a.double() for a in (x, dt, A, Bc, Cc,
                                                         D))), y)
    assert ms.launches.value == before


@pytest.mark.parametrize("case", ["t_chunk", "d_tile", "dt_shape",
                                  "bc_shape", "a_shape", "d_shape", "rank",
                                  "device"])
def test_kernel_preconditions_raise(case):
    x, dt, Bc, Cc, A, D = make_inputs(3, 1, 64, 16, 4)
    kw = dict(chunk=16, d_tile=8)
    if case == "t_chunk":
        kw["chunk"] = 48                                   # 64 % 48
    elif case == "d_tile":
        kw["d_tile"] = 12                                  # 16 % 12
    elif case == "dt_shape":
        dt = dt[:, :32]
    elif case == "bc_shape":
        Bc = Bc[..., :2]
    elif case == "a_shape":
        A = A[:8]
    elif case == "d_shape":
        D = D[:8]
    elif case == "rank":
        x = x[0]
    else:
        Cc = Cc.to("meta")
    before = ms.launches.value
    with pytest.raises(ValueError):
        ms.mamba_scan(x, dt, Bc, Cc, A, D, **kw)
    assert ms.launches.value == before


def test_mamba_cores_follow_reference_conditions():
    """The three scan cores on one layer: "pallas" (the plain version here)
    and "xla" agree, "identity" skips the recurrence; return_state gives
    the same h under every core (the plain scan's); the kernel core keeps
    the reference's precondition T % min(128, T) == 0; decode steps from
    the returned cache continue the sequence."""
    mc = blk.MambaConfig(d_model=32, d_inner=64, d_state=8)
    gen = torch.Generator().manual_seed(0)
    p = blk.init_mamba(gen, mc)
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    assert torch.equal(p["A_log"][5], torch.log(torch.arange(1.0, 9.0)))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 256, 32)).astype(np.float32))
    outs = {}
    for core in ("xla", "pallas", "identity"):
        c = dataclasses.replace(mc, scan_core=core)
        outs[core], cache = blk.mamba_apply(p, c, x, return_state=True)
        if core == "xla":
            h0 = cache["h"]
        assert torch.equal(h0, cache["h"])
        assert tuple(cache["conv"].shape) == (2, 3, 64)
    tp.assert_close(outs["xla"], outs["pallas"])
    assert not torch.allclose(outs["xla"], outs["identity"], atol=1e-3)
    with pytest.raises(ValueError):
        blk.mamba_apply(p, dataclasses.replace(mc, scan_core="pallas"),
                        x[:, :200])
    blk.mamba_apply(p, mc, x[:, :200])                     # xla: any T
    # prefill of 200 steps + 4 decode steps == 204 steps at once
    full = blk.mamba_apply(p, mc, x[:, :204])
    _, cache = blk.mamba_apply(p, mc, x[:, :200], return_state=True)
    for t in range(200, 204):
        y, cache = blk.mamba_decode(p, mc, x[:, t:t + 1], cache)
        tp.assert_close(full[:, t:t + 1], y)


def test_moe_rule_and_capacity_drops():
    """choose_moe_path's readings at Jamba's FULL (16 experts) and REDUCED
    (4 experts) configs, top-2; the sparse path equals the dense one where
    the capacity drops nothing, and differs where a skewed router sends
    every token to expert 0 past its capacity at the default 1.25."""
    full, red = configs.get_config(ARCH).moe_cfg(), CFG.moe_cfg()
    assert (full.n_experts, full.top_k, red.n_experts) == (16, 2, 4)
    assert [blk.choose_moe_path(full, n) for n in (4, 32, 4096)] == \
        ["dense", "dense", "sparse"]
    assert [blk.choose_moe_path(red, n) for n in (32, 4096, 6700)] == \
        ["dense", "dense", "sparse"]
    assert blk.choose_moe_path(dataclasses.replace(red, dispatch="sparse"),
                               4) == "sparse"
    assert blk.moe_density(full) == 2 / 16
    gen = torch.Generator().manual_seed(1)
    cfg = blk.MoEConfig(d_model=32, n_experts=4, top_k=2, d_ff_expert=48)
    p = blk.init_moe(gen, cfg, torch.float32)
    assert p["router"].dtype == torch.float32
    assert tuple(p["w_down"].shape) == (4, 48, 32)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    wide = dataclasses.replace(cfg, capacity_factor=4.0)
    dense, aux_d = blk.moe_apply_dense(p, cfg, x)
    sparse, aux_s = blk.moe_apply_sparse(p, wide, x)
    tp.assert_close(dense, sparse)
    assert float(aux_d) == float(aux_s) > 0
    skew = dict(p, router=p["router"] + torch.tensor([0.5, 0, 0, 0]))
    _, idx, _ = blk._moe_gates(skew, cfg, x + 1.0)
    assert bool((idx == 0).any(-1).all())            # every token to 0
    dropped = blk.moe_apply_sparse(skew, cfg, x + 1.0)[0]
    kept = blk.moe_apply_sparse(skew, wide, x + 1.0)[0]
    tp.assert_close(blk.moe_apply_dense(skew, cfg, x + 1.0)[0], kept)
    # capacity ceil(64 * 2 / 4 * 1.25) = 40 of expert 0's 64 tokens: the
    # last 24 in token order lose expert 0's share, the first 40 keep it
    diff = (dropped - kept).abs().amax(-1)
    assert bool((diff[:40] < 1e-6).all()) and bool((diff[40:] > 1e-6).all())
    shared = blk.init_moe(gen, dataclasses.replace(cfg, n_shared=1,
                                                   d_ff_shared=48))
    assert tuple(shared["shared"]["w_up"].shape) == (32, 48)
    assert "shared" not in p


# capacity_factor E / k = 2: an expert's capacity is every token, so the
# sparse path drops nothing (a capacity that drops makes the output depend
# on how many tokens share a call, so prefill + decode could not match)
@pytest.mark.parametrize("change", [dict(PROFILE),
                                    dict(mamba_core="xla",
                                         moe_dispatch="sparse",
                                         capacity_factor=2.0),
                                    dict(PROFILE, scan_layers=False)])
def test_prefill_decode_match_forward(change):
    """prefill, then teacher-forced decode_step, gives the forward's
    logits (the reference's invariant) under the serving profile, under
    the "xla" core with the sparse MoE path pinned (without drops), and
    with the layers as a list; each agrees with the "xla" core's dense
    forward; the aux loss is the MoE layers'."""
    cfg = dataclasses.replace(CFG, **change)
    p = _params(cfg)
    toks = _tokens(2, 32, seed=6)
    fwd, aux = lm.forward(p, cfg, dict(tokens=toks))
    assert tuple(fwd.shape) == (2, 32, 256) and torch.isfinite(fwd).all()
    assert float(aux["aux_loss"]) > 0
    other = steps.make_prefill_step(dataclasses.replace(
        cfg, mamba_core="identity"))(p, dict(tokens=toks))
    assert not torch.allclose(fwd, other, **LM_TOL)
    base = steps.make_prefill_step(dataclasses.replace(
        cfg, mamba_core="xla", moe_dispatch="adaptive"))(p, dict(tokens=toks))
    tp.assert_close(fwd, base)
    P, S = 16, 32
    logits, caches = lm.prefill(p, cfg, dict(tokens=toks[:, :P]), s_max=S)
    tp.assert_close(fwd[:, :P], logits, **LM_TOL)
    serve = steps.make_serve_step(cfg)
    for t in range(P, S):
        nxt, lg, caches = serve(p, caches, toks[:, t:t + 1], t)
        tp.assert_close(fwd[:, t], lg[:, 0], **LM_TOL)
        assert torch.equal(nxt[:, 0], lg[:, 0, :cfg.vocab].argmax(-1)
                           .to(torch.int32))


def test_decode_writes_jamba_caches_in_place():
    p = _params()
    caches = lm.init_cache(CFG, 2, 10, device="cpu")
    c = caches[0]
    assert sorted(c) == [f"l{i}" for i in range(8)]
    assert set(c["l3"]) == {"k", "v"} and set(c["l0"]) == {"h", "conv"}
    assert tuple(c["l0"]["h"].shape) == (1, 2, 128, 4)
    assert c["l0"]["h"].dtype == torch.float32
    assert tuple(c["l5"]["conv"].shape) == (1, 2, 3, 128)
    assert tuple(c["l3"]["k"].shape) == (1, 2, 10, 2, 16)
    tensors = lm._leaves(c)
    toks = _tokens(2, 1, seed=7)
    logits, nxt, out = lm.decode_step(p, CFG, caches, toks, 0)
    assert out is caches
    assert all(a is b for a, b in zip(lm._leaves(out[0]), tensors))
    assert tuple(logits.shape) == (2, 1, 256) and nxt.dtype == torch.int32
    assert all(a.abs().sum() > 0 for a in tensors)
    listed = lm.init_cache(dataclasses.replace(CFG, scan_layers=False), 2,
                           10, device="cpu")
    assert isinstance(listed[0], list) and len(listed[0]) == 1
    bf = lm.init_cache(dataclasses.replace(CFG, dtype="bfloat16"), 1, 4,
                       device="cpu")
    assert bf[0]["l1"]["h"].dtype == torch.float32
    assert bf[0]["l1"]["conv"].dtype == bf[0]["l3"]["v"].dtype == \
        torch.bfloat16


def test_serve_lm_jamba_under_its_profile():
    """serve_lm applies the reference's serving profile per family (the
    flash core where there is attention, the kernel core of Jamba's Mamba
    layers, of RWKV-6's recurrence) and then the overrides; the same
    tokens under the plain core."""
    assert serve_mod.serving_profile(CFG) == dict(mamba_core="pallas",
                                                  attn_core="flash")
    rwkv = configs.get_config("rwkv6_7b", reduced=True)
    assert serve_mod.serving_profile(rwkv) == dict(wkv_core="pallas")
    assert serve_mod.serving_profile(
        configs.get_config("internlm2_1_8b", reduced=True)) == dict(
            attn_core="flash")
    runs = [serve_mod.serve_lm(ARCH, batch=2, prompt_len=16, gen=5, seed=3,
                               device="cpu", overrides=ov, verbose=False)
            for ov in (None, dict(mamba_core="xla"))]
    for out in runs:
        assert out["tokens"].shape == (2, 5)
        assert out["tokens"].dtype == np.int32
        assert ((out["tokens"] >= 0) & (out["tokens"] < CFG.vocab)).all()
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])


def test_lm_from_jax_params_keeps_jamba_float32_leaves():
    p = _params()
    tree = lm._tree_map(lambda a: a.numpy(), p)
    got = lm_from_jax_params(tree, CFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(lm._leaves(got),
                                                 lm._leaves(p)))
    bf = lm_from_jax_params(tree, dataclasses.replace(CFG, dtype="bfloat16"),
                            device="cpu")
    g = bf["groups"][0]
    for i in (0, 1, 7):
        mixer = g[f"l{i}"]["mixer"]
        assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
        assert mixer["in_proj"].dtype == torch.bfloat16
    assert g["l1"]["ffn"]["router"].dtype == torch.float32
    assert g["l1"]["ffn"]["w_gate"].dtype == torch.bfloat16
    assert g["l3"]["mixer"]["wq"].dtype == g["l0"]["ffn"]["w_up"].dtype == \
        torch.bfloat16
    assert torch.equal(g["l1"]["ffn"]["router"],
                       p["groups"][0]["l1"]["ffn"]["router"])
    bad = lm._tree_map(lambda a: a, tree)
    del bad["groups"][0]["l2"]["mixer"]["D"]
    with pytest.raises(ValueError, match="l2.mixer"):
        lm_from_jax_params(bad, CFG, device="cpu")


def test_full_config_size_on_the_meta_device():
    """One period at FULL widths (n_layers=8, the depth the card holds):
    13,295,235,072 parameters, as the reference's init_params has them
    (jax.eval_shape); shapes from the carrier's table, which the reduced
    config's init_params matches leaf for leaf."""
    full = configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.n_experts,
            full.top_k, full.vocab) == (32, 4096, 14336, 16, 2, 65536)
    assert full.layer_groups() == [("jamba_period", 4)]
    one = dataclasses.replace(full, n_layers=8)
    mc = one.mamba_cfg()
    assert (mc.d_inner, mc.d_state, mc.rank, mc.d_conv) == (8192, 16, 256, 4)

    def meta(shapes):
        if isinstance(shapes, dict):
            return {k: meta(v) for k, v in shapes.items()}
        return torch.empty(tuple(shapes), device="meta")

    layer = meta(_lm_layer_shapes(one, "jamba_period"))
    n = sum(a.numel() for a in lm._leaves(layer))
    top = 2 * one.padded_vocab * one.d_model + one.d_model
    assert n + top == 13_295_235_072
    assert (n + top) * 2 / 1e9 == pytest.approx(26.59, abs=0.01)   # bf16

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{path}.{key}").items()}
        return {path: tree}

    small = {k: tuple(a.shape[1:])
             for k, a in flat(_params()["groups"][0]).items()}
    want = {k: tuple(a.shape) for k, a in flat(meta(_lm_layer_shapes(
        CFG, "jamba_period"))).items()}
    assert small == want


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "rwkv6_7b", ARCH])
def test_init_params_fills_stacks_as_stacking_layers_would(arch):
    """init_params allocates each group's stacks once and fills them layer
    by layer; the values equal the old list-then-stack construction from
    the same generator (and a group of one layer is a view of it)."""
    cfg = configs.get_config(arch, reduced=True)
    got = _params(cfg, seed=2)
    gen = lm.make_generator(2, "cpu")
    from repro_torch.layers import nn
    V = cfg.padded_vocab
    want = dict(embed=nn.trunc_normal(gen, (V, cfg.d_model)))
    if not cfg.tie_embeddings:
        want["lm_head"] = nn.trunc_normal(gen, (cfg.d_model, V))
    groups = [lm._stack([lm.init_layer(gen, cfg, kind) for _ in range(n)])
              for kind, n in cfg.layer_groups()]
    for k, a in want.items():
        assert torch.equal(got[k], a), k
    for g, w in zip(got["groups"], groups):
        ga, wa = lm._leaves(g), lm._leaves(w)
        assert len(ga) == len(wa)
        assert all(torch.equal(a, b) for a, b in zip(ga, wa))
        assert all(a.is_contiguous() for a in ga)
