"""The port's RWKV-6 slice on the CPU, with torch and numpy only (no JAX
compile): the plain chunked form against the sequential oracle, chunk
invariance and the state carry (tests/test_kernels_rwkv6.py's checks),
the kernel wrapper's CPU contract and preconditions, the four time-mix
cores, RWKV6-7B's reduced config through prefill, decode (in-place
caches) and serve_lm, and the parameter carrier's float32 ``u`` and
``w0``.  Parity with the reference is in tests/test_torch_jax_parity.py;
the CUDA kernel is checked on the card by tests/test_torch_cuda.py.
Tolerances are the reference's: float32 atol 5e-4 / rtol 1e-3 against the
oracle, atol 1e-3 / rtol 2e-3 across chunk sizes, and LM logits at 1e-3
(tests/test_models_smoke.py)."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import _build, ref
from repro_torch.kernels import rwkv6_chunked as rk
from repro_torch.launch import serve_lm as serve_mod
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.train import steps
from repro_torch.weights import lm_from_jax_params

ARCH = "rwkv6_7b"
CFG = configs.get_config(ARCH, reduced=True)
TOL = dict(atol=5e-4, rtol=1e-3)            # tests/test_kernels_rwkv6.py
LM_TOL = dict(atol=1e-3, rtol=1e-3)         # tests/test_models_smoke.py


def make_inputs(seed, B, H, T, dh, dtype=torch.float32, rate=None):
    """tests/test_kernels_rwkv6.py's inputs, from numpy: decay rates
    clipped to the model's [-20, 0.405], or all equal to ``rate``."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, dh))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    if rate is None:
        rates = np.clip(rng.standard_normal((B, H, T, dh)), -20, 0.405)
    else:
        rates = np.full((B, H, T, dh), rate)
    w = torch.from_numpy(np.exp(-np.exp(rates)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((H, dh)).astype(np.float32))
    return r, k, v, w, u


def _params(cfg=CFG, seed: int = 0):
    return lm.init_params(lm.make_generator(seed, "cpu"), cfg)


def _tokens(B: int, S: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, CFG.vocab, (B, S))
                            .astype(np.int32))


@pytest.mark.parametrize("B,H,T,dh,chunk", [
    (1, 1, 32, 8, 8), (2, 3, 64, 16, 16), (2, 2, 128, 64, 32),
    (1, 4, 256, 32, 64),
])
def test_chunked_matches_sequential_oracle(B, H, T, dh, chunk):
    r, k, v, w, u = make_inputs(B + T, B, H, T, dh)
    o, S = rk.rwkv6_chunked(r, k, v, w, u, chunk=chunk)
    want, S_want = ref.rwkv6_recurrence(r, k, v, w, u)
    assert o.dtype == torch.float32 and tuple(S.shape) == (B, H, dh, dh)
    tp.assert_close(ref.rwkv6_linear_attention(r, k, v, w, u), o, **TOL)
    tp.assert_close(want, o, **TOL)
    tp.assert_close(S_want, S, **TOL)


@pytest.mark.parametrize("t_chunks,dh,seed", [(1, 8, 0), (3, 16, 1),
                                              (6, 8, 2), (4, 16, 3)])
def test_chunk_invariance(t_chunks, dh, seed):
    """The output does not depend on the chunk size (the reference's
    property test, on fixed seeds)."""
    T = t_chunks * 32
    r, k, v, w, u = make_inputs(seed, 1, 1, T, dh)
    want = ref.rwkv6_linear_attention(r, k, v, w, u)
    for c in (8, 16, 32):
        o, _ = rk.rwkv6_chunked(r, k, v, w, u, chunk=c)
        tp.assert_close(want, o, atol=1e-3, rtol=2e-3)


def test_state_carry_matches():
    """Chunked with an initial state == the oracle on the full sequence;
    the recurrence carries its state the same way."""
    B, H, T, dh = 1, 2, 64, 16
    r, k, v, w, u = make_inputs(11, B, H, T, dh)
    full = ref.rwkv6_linear_attention(r, k, v, w, u)
    h = T // 2
    first = [a[:, :, :h] for a in (r, k, v, w)]
    second = [a[:, :, h:] for a in (r, k, v, w)]
    o1, S = rk.rwkv6_chunked(*first, u, chunk=16)
    o2, _ = rk.rwkv6_chunked(*second, u, chunk=16, state=S)
    tp.assert_close(full, torch.cat([o1, o2], dim=2), **TOL)
    s1, S1 = ref.rwkv6_recurrence(*first, u)
    s2, _ = ref.rwkv6_recurrence(*second, u, state=S1)
    tp.assert_close(full, torch.cat([s1, s2], dim=2), atol=1e-6, rtol=1e-6)


def test_kernel_cpu_runs_plain_without_launching():
    """CPU tensors run the plain version (the sequential oracle) and launch
    nothing; the output keeps r's dtype; at chunk 128 and the decay floor,
    where the plain chunked form overflows (as the reference's does), the
    wrapper's result is finite."""
    before = rk.launches.value
    r, k, v, w, u = make_inputs(2, 2, 2, 64, 16)
    got = rk.rwkv6_chunked_kernel(r, k, v, w, u, chunk=16)
    assert torch.equal(got, rk.plain(r, k, v, w, u))
    assert rk.plain is ref.rwkv6_linear_attention
    bf = [a.bfloat16() for a in (r, k, v)]
    out = rk.rwkv6_chunked_kernel(*bf, w, u, chunk=32)
    assert out.dtype == torch.bfloat16 and out.shape == r.shape
    r, k, v, w, u = make_inputs(3, 1, 2, 256, 64, rate=0.405)
    # inherited (ROADMAP section 3 fault 7): e^{-c} overflows within a
    # chunk of 64 or more steps at log w = -1.5; the NaN counts are the
    # reference's Pallas kernel's at these shapes
    nans = {c: int(torch.isnan(rk.rwkv6_chunked(r, k, v, w, u,
                                                chunk=c)[0]).sum())
            for c in (32, 64, 128)}
    assert nans == {32: 0, 64: 2560, 128: 17664}, nans
    o32, _ = rk.rwkv6_chunked(r, k, v, w, u, chunk=32)
    got = rk.rwkv6_chunked_kernel(r, k, v, w, u, chunk=128)
    assert torch.isfinite(got).all()
    tp.assert_close(got, o32, **TOL)
    assert rk.launches.value == before


@pytest.mark.parametrize("case", ["t_chunk", "k_shape", "w_shape", "u_shape",
                                  "rank", "dtype", "device"])
def test_kernel_preconditions_raise(case):
    r, k, v, w, u = make_inputs(4, 1, 2, 64, 16)
    chunk = 16
    if case == "t_chunk":
        chunk = 48                                      # 64 % 48
    elif case == "k_shape":
        k = k[:, :, :32]
    elif case == "w_shape":
        w = w[..., :8]
    elif case == "u_shape":
        u = u[:1]
    elif case == "rank":
        r, k, v, w = (a[0] for a in (r, k, v, w))
    elif case == "dtype":
        v = v.bfloat16()
    else:
        w = w.to("meta")
    before = rk.launches.value
    with pytest.raises(ValueError):
        rk.rwkv6_chunked_kernel(r, k, v, w, u, chunk=chunk)
    assert rk.launches.value == before
    if case == "t_chunk":
        with pytest.raises(ValueError):
            rk.rwkv6_chunked(r, k, v, w, u, chunk=chunk)


def test_time_mix_cores_follow_reference_conditions(monkeypatch):
    """The four WKV cores under the reference's rule (blocks.py:720-738):
    identity; the kernel only from a zero state with T % chunk == 0 and
    T > chunk (its state comes back as zeros); the chunked form under the
    same length rule; else the sequential recurrence.  Every core that
    computes the recurrence gives the same output."""
    called = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            called.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(rk, fn.__name__, wrapped)

    spy("kernel", rk.rwkv6_chunked_kernel)
    spy("chunked", rk.rwkv6_chunked)
    rc = CFG.rwkv_cfg()                                 # chunk 8
    p = _params()["groups"][0]["tm"]
    p = {k: a[0] for k, a in p.items()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 32, 128)).astype(np.float32))
    state = torch.from_numpy(
        rng.standard_normal((2, 2, 64, 64)).astype(np.float32)) * 0.1
    outs = {}
    for core in ("xla", "pallas", "identity"):
        c = dataclasses.replace(rc, wkv_core=core)
        called.clear()
        outs[core], (x_last, S) = blk.rwkv6_time_mix(p, c, x)
        assert torch.equal(x_last, x[:, -1:])
        want = {"xla": ["chunked"], "pallas": ["kernel"], "identity": []}
        assert called == want[core], (core, called)
        if core == "pallas":
            assert not S.any()
        # with a state the kernel core takes the chunked form, and on a
        # sequence that is not a multiple of the chunk the recurrence
        called.clear()
        blk.rwkv6_time_mix(p, c, x, state=state)
        blk.rwkv6_time_mix(p, c, x[:, :20])
        blk.rwkv6_time_mix(p, c, x[:, :8])               # T == chunk
        blk.rwkv6_time_mix(p, c, x, use_chunked=False)
        assert called == ([] if core == "identity" else ["chunked"]), called
    seq, (_, S_seq) = blk.rwkv6_time_mix(p, rc, x, use_chunked=False)
    tp.assert_close(seq, outs["xla"], **TOL)
    tp.assert_close(seq, outs["pallas"], **TOL)
    assert not torch.allclose(seq, outs["identity"])
    _, (_, S_chk) = blk.rwkv6_time_mix(p, rc, x)
    tp.assert_close(S_seq, S_chk, **TOL)


def test_blocks_shapes_and_float32_leaves():
    rc = CFG.rwkv_cfg()
    assert (rc.n_heads, rc.head_dim, rc.chunk, rc.d_ff) == (2, 64, 8, 256)
    gen = torch.Generator().manual_seed(0)
    tm = blk.init_rwkv6(gen, rc, torch.bfloat16)
    assert tm["u"].dtype == tm["w0"].dtype == torch.float32
    assert tuple(tm["u"].shape) == (2, 64) and not tm["w0"].any()
    assert tm["wr"].dtype == tm["mu_g"].dtype == torch.bfloat16
    assert tuple(tm["w_lora_a"].shape) == (128, 64)
    cm = blk.init_rwkv6_cm(gen, dataclasses.replace(rc, d_ff=0))
    assert tuple(cm["wk"].shape) == (128, 448)      # 3.5 d_model
    x = torch.randn((2, 5, 128), generator=gen)
    out, x_last = blk.rwkv6_channel_mix(cm, x)
    assert out.shape == x.shape and torch.equal(x_last, x[:, -1:])
    # token shift: the first position mixes with x_prev
    prev = torch.randn((2, 1, 128), generator=gen)
    a, _ = blk.rwkv6_channel_mix(cm, x, x_prev=prev)
    assert torch.equal(a[:, 1:], out[:, 1:]) and not torch.equal(a, out)


@pytest.mark.parametrize("core", ["xla", "pallas"])
@pytest.mark.parametrize("scan_layers", [True, False])
def test_prefill_decode_match_forward(core, scan_layers):
    """prefill, then teacher-forced decode_step, gives the forward's
    logits (the reference's invariant) under either core; the two cores'
    forwards agree."""
    cfg = dataclasses.replace(CFG, wkv_core=core, scan_layers=scan_layers)
    p = _params(cfg)
    toks = _tokens(2, 32, seed=6)
    fwd = steps.make_prefill_step(cfg)(p, dict(tokens=toks))
    assert tuple(fwd.shape) == (2, 32, 256) and torch.isfinite(fwd).all()
    other = steps.make_prefill_step(dataclasses.replace(
        cfg, wkv_core="xla" if core == "pallas" else "pallas"))(
            p, dict(tokens=toks))
    tp.assert_close(fwd, other, **TOL)
    P, S = 16, 32
    logits, caches = lm.prefill(p, cfg, dict(tokens=toks[:, :P]), s_max=S)
    tp.assert_close(fwd[:, :P], logits, **LM_TOL)
    serve = steps.make_serve_step(cfg)
    for t in range(P, S):
        nxt, lg, caches = serve(p, caches, toks[:, t:t + 1], t)
        tp.assert_close(fwd[:, t], lg[:, 0], **LM_TOL)
        assert torch.equal(nxt[:, 0], lg[:, 0, :cfg.vocab].argmax(-1)
                           .to(torch.int32))


def test_decode_writes_rwkv_caches_in_place():
    p = _params()
    caches = lm.init_cache(CFG, 2, 10, device="cpu")
    c = caches[0]
    assert set(c) == {"S", "x_tm", "x_cm"}
    assert tuple(c["S"].shape) == (2, 2, 2, 64, 64)
    assert c["S"].dtype == torch.float32
    assert tuple(c["x_tm"].shape) == (2, 2, 1, 128) and not c["x_tm"].any()
    tensors = {k: a for k, a in c.items()}
    toks = _tokens(2, 1, seed=7)
    logits, nxt, out = lm.decode_step(p, CFG, caches, toks, 0)
    assert out is caches and all(out[0][k] is a for k, a in tensors.items())
    assert tuple(logits.shape) == (2, 1, 256) and nxt.dtype == torch.int32
    assert all(a.abs().sum() > 0 for a in c.values())
    before = {k: a.clone() for k, a in c.items()}
    lm.decode_step(p, CFG, caches, toks, 1)
    assert all(not torch.equal(before[k], c[k]) for k in c)
    listed = dataclasses.replace(CFG, scan_layers=False)
    lc = lm.init_cache(listed, 2, 10, device="cpu")
    assert isinstance(lc[0], list) and tuple(lc[0][1]["S"].shape) == (
        2, 2, 64, 64)
    bf = lm.init_cache(dataclasses.replace(CFG, dtype="bfloat16"), 1, 4,
                       device="cpu")
    assert bf[0]["S"].dtype == torch.float32
    assert bf[0]["x_cm"].dtype == torch.bfloat16


def test_serve_lm_rwkv_is_deterministic_under_both_cores():
    runs = [serve_mod.serve_lm(ARCH, batch=2, prompt_len=16, gen=5, seed=3,
                               device="cpu", overrides=ov, verbose=False)
            for ov in (None, dict(wkv_core="pallas"),
                       dict(wkv_core="pallas"))]
    for out in runs:
        assert out["tokens"].shape == (2, 5)
        assert out["tokens"].dtype == np.int32
        assert ((out["tokens"] >= 0) & (out["tokens"] < CFG.vocab)).all()
    np.testing.assert_array_equal(runs[1]["tokens"], runs[2]["tokens"])
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    with pytest.raises(TypeError):
        serve_mod.serve_lm(ARCH, device="cpu", overrides=dict(nope=1),
                           verbose=False)


def test_lm_from_jax_params_keeps_rwkv_u_and_w0_float32():
    p = _params()
    tree = lm._tree_map(lambda a: a.numpy(), p)
    got = lm_from_jax_params(tree, CFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(lm._leaves(got),
                                                 lm._leaves(p)))
    bf = lm_from_jax_params(tree, dataclasses.replace(CFG, dtype="bfloat16"),
                            device="cpu")
    tm = bf["groups"][0]["tm"]
    assert tm["u"].dtype == tm["w0"].dtype == torch.float32
    assert torch.equal(tm["u"], p["groups"][0]["tm"]["u"])
    assert tm["wr"].dtype == bf["groups"][0]["cm"]["wk"].dtype == \
        torch.bfloat16
    assert bf["lm_head"].dtype == torch.bfloat16
    listed = dataclasses.replace(CFG, scan_layers=False)
    per_layer = [lm._tree_map(lambda a, i=i: a[i], tree["groups"][0])
                 for i in range(2)]
    got = lm_from_jax_params(dict(tree, groups=[per_layer]), listed,
                             device="cpu")
    assert torch.equal(got["groups"][0][1]["tm"]["u"],
                       p["groups"][0]["tm"]["u"][1])
    bad = dict(tree, groups=[dict(tree["groups"][0],
                                  tm=dict(tree["groups"][0]["tm"], u=None))])
    del bad["groups"][0]["tm"]["u"]
    with pytest.raises(ValueError, match="tm"):
        lm_from_jax_params(bad, CFG, device="cpu")


def test_rwkv_config_and_cost_models():
    full = configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab,
            full.rwkv_chunk) == (32, 4096, 14336, 65536, 128)
    assert full.layer_groups() == [("rwkv", 32)] and full.subquadratic
    assert full.torch_dtype == torch.bfloat16 and not full.tie_embeddings
    rc = full.rwkv_cfg()
    assert (rc.n_heads, rc.head_dim, rc.chunk) == (64, 64, 128)
    assert configs.get_config("rwkv6-7b", reduced=True) is CFG
    assert configs.shape_applicable(full, "long_500k") == (True, "")
    assert rk.rwkv6_hbm_bytes(4, 64, 1024, 64) == 5 * 4 * 64 * 1024 * 64 * 4
    assert rk.rwkv6_flops(4, 64, 1024, 64, chunk=128) == \
        4 * 64 * 8 * (2.0 * 128 * 128 * 64 + 4.0 * 128 * 64 * 64)
    # the bound counts operations at the CUDA kernel's own chunk; its state
    # is float64 on the tensor cores (no float32-state variant is built),
    # and a library built with other flags never takes the kernel's digest
    src = (_build.CSRC / "rwkv6_chunked.cu").read_text()
    assert f"constexpr int kL = {rk.KERNEL_CHUNK};" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64" in src
    assert "RWKV6_STATE_T" not in src
    assert _build._digest("rwkv6_chunked") != _build._digest(
        "rwkv6_chunked", (*_build.NVCC_FLAGS, "-lineinfo"))
