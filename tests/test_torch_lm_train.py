"""The port's LM training slice on the CPU, with torch and numpy only (no
JAX compile): remat's three policies, the Mamba scans under autograd, the
forward-only kernels' refusal of gradients, the train step's contract
(accumulation, compression, inputs left untouched), AdamW's dtypes, and
launch/train.py with its checkpoint and resume.  Parity with the
reference is in tests/test_torch_jax_parity.py; the train step on the
card in tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import SimulatedCrash, compression
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_chunked as rk
from repro_torch.launch import train as train_mod
from repro_torch.models import blocks, lm
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCHS = ("internlm2_1_8b", "jamba_v0_1_52b", "rwkv6_7b")


def _cfg(arch: str, **changes):
    return dataclasses.replace(configs.get_config(arch, reduced=True),
                               **changes)


def _batch(cfg, B: int = 2, S: int = 32, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32))
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:])


def _loss_and_grads(params, cfg, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = lm.loss_fn(tree_unflatten(params, leaves), cfg,
                               batch)
    return loss.detach(), metrics, torch.autograd.grad(loss, leaves)


class _Calls:
    """Counts the calls of a kernel module's plain version (what its
    wrapper runs on CPU tensors, where it would launch on CUDA ones)."""

    def __init__(self, monkeypatch, mod):
        self.n = 0
        plain = mod.plain

        def counted(*a, **k):
            self.n += 1
            return plain(*a, **k)

        monkeypatch.setattr(mod, "plain", counted)


@pytest.mark.parametrize("arch,changes", [
    ("internlm2_1_8b", dict(attn_core="flash")),
    ("jamba_v0_1_52b", dict(mamba_core="pallas", attn_core="flash")),
    ("jamba_v0_1_52b", dict(mamba_core="xla")),
    ("rwkv6_7b", dict())])
def test_remat_policies_give_the_same_loss_and_gradients(monkeypatch, arch,
                                                         changes):
    """remat "none", "full" and "dots" give the same loss, metrics and
    gradients (the same arithmetic, recomputed), and a recomputed layer
    runs its kernels again: flash and mamba_scan run twice per layer under
    "full" and "dots", once under "none" (S = 128, so the flash core
    takes the kernel).  Without autograd remat changes nothing."""
    base = _cfg(arch, **changes)
    params = lm.init_params(lm.make_generator(0, "cpu"), base)
    batch = _batch(base, S=128)
    n_attn = {"internlm2_1_8b": base.n_layers,
              "jamba_v0_1_52b": 1}.get(arch, 0)
    n_mamba = 7 if changes.get("mamba_core") == "pallas" else 0
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        flash, scan = _Calls(monkeypatch, fa), _Calls(monkeypatch, ms)
        out[remat] = _loss_and_grads(params, cfg, batch)
        times = 1 if remat == "none" else 2
        attn_kernel = changes.get("attn_core") == "flash"
        assert flash.n == times * n_attn * attn_kernel, remat
        assert scan.n == times * n_mamba, remat
        with torch.no_grad():
            flash.n = scan.n = 0
            logits, _ = lm.forward(params, cfg, batch)
            assert flash.n == n_attn * attn_kernel and scan.n == n_mamba
        out[remat] += (logits,)
    loss, metrics, grads, logits = out["none"]
    for remat in ("full", "dots"):
        l2, m2, g2, lg2 = out[remat]
        assert torch.equal(loss, l2) and torch.equal(logits, lg2)
        assert all(torch.equal(metrics[k], m2[k]) for k in metrics)
        for a, b in zip(grads, g2):
            tp.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_ssm_scan_under_grad_matches_the_recurrence():
    """_ssm_scan under autograd (out of place) equals its in-place
    inference form bit for bit, and its states, the Mamba layer's output
    and their gradients match autograd through the sequential
    ref.mamba_recurrence (float32, 1e-5)."""
    rng = np.random.default_rng(5)
    B, T, di, ds = 2, 37, 8, 4
    x = torch.from_numpy(rng.standard_normal((B, T, di)).astype(np.float32))
    dt = torch.from_numpy((np.abs(rng.standard_normal((B, T, di))) * 0.3)
                          .astype(np.float32))
    Bc, Cc = (torch.from_numpy(rng.standard_normal((B, T, ds))
                               .astype(np.float32)) for _ in range(2))
    A = torch.from_numpy(-(np.abs(rng.standard_normal((di, ds))) + 0.1)
                         .astype(np.float32))
    D = torch.from_numpy(rng.standard_normal((di,)).astype(np.float32))
    with torch.no_grad():
        h_inplace = blocks._mamba_states(dt, x, Bc, A)
    ins = [t.clone().requires_grad_() for t in (x, dt, Bc, Cc, A, D)]
    xg, dtg, Bg, Cg, Ag, Dg = ins
    hs = blocks._mamba_states(dtg, xg, Bg, Ag)
    assert hs.requires_grad and torch.equal(hs.detach(), h_inplace)
    y = torch.einsum("btds,bts->btd", hs, Cg) + xg * Dg
    cot = torch.from_numpy(rng.standard_normal((B, T, di)).astype(np.float32))
    got = torch.autograd.grad((y * cot).sum(), ins)
    ins2 = [t.clone().requires_grad_() for t in (x, dt, Bc, Cc, A, D)]
    want_y, _ = ref.mamba_recurrence(ins2[0], ins2[1], ins2[4], ins2[2],
                                     ins2[3], ins2[5])
    want = torch.autograd.grad((want_y * cot).sum(), ins2)
    tp.assert_close(want_y.detach(), y, atol=1e-5, rtol=1e-5)
    for a, b in zip(want, got):
        tp.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # the scan's trainable wrapper: same gradients as autograd through the
    # plain oracle; its forward on CPU tensors is that oracle
    y3 = ms.mamba_scan_trainable(*ins)
    got3 = torch.autograd.grad((y3 * cot).sum(), ins)
    for a, b in zip(want, got3):
        tp.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_forward_only_kernels_refuse_gradients():
    """mamba_scan, rwkv6_chunked_kernel and flash_attention raise, on CPU
    tensors as on CUDA ones, where autograd would differentiate their
    result, and run under no_grad or without an input requiring grad;
    wkv_core="pallas" under grad raises NotImplementedError, and RWKV-6
    trains under the "xla" core."""
    rng = np.random.default_rng(6)

    def t(*shape, grad=False):
        a = torch.from_numpy(rng.random(shape).astype(np.float32) * 0.5)
        return a.requires_grad_(grad)

    calls = [
        (ms.mamba_scan, lambda g: (t(1, 8, 4, grad=g), t(1, 8, 4), t(1, 8, 2),
                                   t(1, 8, 2), -t(4, 2) - 0.1, t(4)),
         "mamba_scan_trainable"),
        (rk.rwkv6_chunked_kernel,
         lambda g: (t(1, 2, 16, 4, grad=g), t(1, 2, 16, 4), t(1, 2, 16, 4),
                    t(1, 2, 16, 4) * 0.5 + 0.5, t(2, 4)), "rwkv6_chunked"),
        (fa.flash_attention, lambda g: (t(1, 2, 16, 8, grad=g),
                                        t(1, 2, 16, 8), t(1, 2, 16, 8)),
         "flash_attention_trainable")]
    for fn, make, hint in calls:
        kw = dict(chunk=8) if fn is rk.rwkv6_chunked_kernel else {}
        with pytest.raises(RuntimeError, match=hint):
            fn(*make(True), **kw)
        assert fn(*make(False), **kw).grad_fn is None
        with torch.no_grad():
            fn(*make(True), **kw)
    cfg = _cfg("rwkv6_7b", wkv_core="pallas")
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    batch = _batch(cfg, S=16)
    with pytest.raises(NotImplementedError, match="wkv_core"):
        _loss_and_grads(params, cfg, batch)
    with torch.no_grad():
        lm.forward(params, cfg, batch)
    step = steps.make_train_step(dataclasses.replace(cfg, wkv_core="xla"),
                                 adamw.OptConfig())
    _, _, m = step(params, adamw.init_state(params), batch)
    assert torch.isfinite(m["loss"])


def test_train_step_accumulates_compresses_and_leaves_inputs(monkeypatch):
    """make_train_step: accum_steps 2 and 4 give accum 1's loss, metrics
    and update (float32 1e-5); the micro-batches are the batch's rows in
    order (positions split on dim 1); an indivisible batch raises; the
    accumulated gradients are float32 on bf16 params and accum 1's keep
    bf16; compression carries ef (topk_ef) or none (bf16); the inputs are
    not modified and the outputs are new tensors; metrics are 0-d."""
    cfg = _cfg("internlm2_1_8b")
    params = lm.init_params(lm.make_generator(1, "cpu"), cfg)
    batch = _batch(cfg, B=4, S=16, seed=2)
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    opt = adamw.init_state(params)
    before = [a.clone() for a in tree_leaves((params, opt))]
    out = {a: steps.make_train_step(cfg, opt_cfg, accum_steps=a)(
        params, opt, batch) for a in (1, 2, 4)}
    assert all(torch.equal(a, b) for a, b in zip(
        before, tree_leaves((params, opt))))
    p1, o1, m1 = out[1]
    assert sorted(m1) == ["aux", "ce", "grad_norm", "loss", "lr"]
    assert all(v.shape == () for v in m1.values())
    assert not any(a is b for a, b in zip(tree_leaves(p1),
                                          tree_leaves(params)))
    for a in (2, 4):
        p, o, m = out[a]
        for k in m1:
            tp.assert_close(m1[k], m[k], atol=1e-5, rtol=1e-5)
        for x, y in zip(tree_leaves((p1, o1)),
                        tree_leaves((p, o))):
            tp.assert_close(x.float(), y.float(), atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="accum_steps"):
        steps.make_train_step(cfg, opt_cfg, accum_steps=3)(params, opt,
                                                           batch)
    parts = steps._split("positions", torch.arange(24).reshape(3, 4, 2), 2)
    assert [p.shape for p in parts] == [(3, 2, 2)] * 2
    assert torch.equal(torch.cat(parts, 1), torch.arange(24).reshape(3, 4, 2))
    assert steps._split("mask", None, 2) == [None, None]

    seen = []
    real = adamw.update

    def spy(p, g, s, c):
        seen.append({t.dtype for t in tree_leaves(g)})
        return real(p, g, s, c)

    monkeypatch.setattr(adamw, "update", spy)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = lm.init_params(lm.make_generator(1, "cpu"), bf)
    bopt = adamw.init_state(bparams)
    for a in (1, 2):
        steps.make_train_step(bf, opt_cfg, accum_steps=a)(bparams, bopt,
                                                          batch)
    # A_log-like float32 leaves aside, InternLM2 is all bf16
    assert seen == [{torch.bfloat16}, {torch.float32}]
    monkeypatch.setattr(adamw, "update", real)

    _, o_bf, m_bf = steps.make_train_step(
        cfg, opt_cfg, grad_compression="bf16")(params, opt, batch)
    assert "ef" not in o_bf and torch.isfinite(m_bf["loss"])
    opt_ef = dict(opt, ef=compression.init_error_feedback(params))
    step = steps.make_train_step(cfg, opt_cfg, grad_compression="topk_ef")
    p2, o2, _ = step(params, opt_ef, batch)
    ef = tree_leaves(o2["ef"])
    assert all(e.dtype == torch.float32 for e in ef)
    # 1 % of each tensor's entries was sent, the rest carried in ef
    for e, g in zip(ef, tree_leaves(params)):
        sent = (e == 0).sum().item()
        assert sent >= max(int(g.numel() * 0.01), 1), g.shape
    _, o3, _ = step(p2, o2, batch)
    assert int(o3["step"]) == 2 and "ef" in o3


def test_adamw_keeps_dtypes_and_clips():
    """bf16 params update in float32 and round back; moments float32; the
    step a 0-d int32 tensor; clipping at max_norm; the schedule's warmup,
    peak and floor."""
    p = dict(w=torch.ones((3,), dtype=torch.bfloat16),
             b=[torch.zeros((2, 2))])
    g = dict(w=torch.full((3,), 4.0, dtype=torch.bfloat16),
             b=[torch.full((2, 2), 3.0)])
    st = adamw.init_state(p)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    assert all(m.dtype == torch.float32 for m in tree_leaves(st["m"]))
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=0, total_steps=10,
                          weight_decay=0.0, min_lr_frac=1.0)
    new_p, new_st, stats = adamw.update(p, g, st, cfg)
    assert new_p["w"].dtype == torch.bfloat16 and int(new_st["step"]) == 1
    tp.assert_close(stats["grad_norm"], np.sqrt(3 * 16 + 4 * 9))
    # sign steps of lr at step 1: 1 - 0.1 in bf16, 0 - 0.1
    tp.assert_close(new_p["w"].float(), torch.full((3,), 0.9).bfloat16()
                    .float(), atol=0, rtol=0)
    tp.assert_close(new_p["b"][0], torch.full((2, 2), -0.1), atol=1e-6)
    clipped, gn = adamw.clip_by_global_norm(g, 1.0)
    tp.assert_close(adamw.global_norm(clipped), 1.0, atol=1e-2)
    sc = adamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.schedule(sc, torch.tensor(s))) for s in (0, 5, 10,
                                                                100, 500)]
    assert lrs[0] == 0.0 and abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6 and abs(lrs[3] - 0.1) < 1e-6
    assert abs(lrs[4] - 0.1) < 1e-6


def test_loss_fn_adds_the_weighted_aux_loss():
    """loss_fn = ce over the unpadded vocab + aux_loss_coef * the MoE
    load-balancing loss (Jamba), now that loss_fn reads aux_loss_coef; a
    mask weights the ce."""
    cfg = _cfg("jamba_v0_1_52b", aux_loss_coef=0.5)
    params = lm.init_params(lm.make_generator(2, "cpu"), cfg)
    batch = _batch(cfg, S=16)
    with torch.no_grad():
        total, m = lm.loss_fn(params, cfg, batch)
        logits, out = lm.forward(params, cfg, batch)
        ce = torch.nn.functional.cross_entropy(
            logits[..., :cfg.vocab].float().flatten(0, 1),
            batch["labels"].long().flatten())
        mask = torch.zeros(batch["labels"].shape)
        mask[:, :4] = 1.0
        masked, _ = lm.loss_fn(params, cfg, dict(batch, mask=mask))
        ce4 = torch.nn.functional.cross_entropy(
            logits[:, :4, :cfg.vocab].float().flatten(0, 1),
            batch["labels"][:, :4].long().flatten())
    assert float(m["aux"]) > 0
    tp.assert_close(ce, m["ce"], atol=1e-6, rtol=1e-6)
    tp.assert_close(ce + 0.5 * out["aux_loss"], total, atol=1e-6, rtol=1e-6)
    tp.assert_close(ce4 + 0.5 * out["aux_loss"], masked, atol=1e-6,
                    rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_losses_are_finite(arch):
    """launch/train.py on each family's REDUCED config on the CPU: finite
    losses, one per step, and a run that repeats bit for bit."""
    kw = dict(steps=3, seq=16, global_batch=4, device="cpu", verbose=False)
    r1 = train_mod.train(arch, **kw)
    assert len(r1["losses"]) == 3 and np.isfinite(r1["losses"]).all()
    assert r1["final_loss"] == r1["losses"][-1]
    r2 = train_mod.train(arch, **kw)
    assert r1["losses"] == r2["losses"]
    assert r1["stragglers"] == []


@pytest.mark.parametrize("comp", ["bf16", "topk_ef"])
def test_launch_train_with_compression_runs(tmp_path, comp):
    """The reference's tests/test_optim_train.py::
    test_train_with_compression_runs, on the port (bf16), and its topk_ef
    twin; both checkpoint every 2 steps (topk_ef's error feedback with the
    state) and resume to the same final loss."""
    kw = dict(seq=16, global_batch=4, grad_compression=comp, device="cpu",
              verbose=False, ckpt_dir=str(tmp_path), ckpt_every=2)
    res = train_mod.train("internlm2_1_8b", steps=3, **kw)
    assert np.isfinite(res["final_loss"])
    again = train_mod.train("internlm2_1_8b", steps=3, **kw)
    assert again["losses"] == res["losses"][2:]


def test_launch_train_checkpoint_resume(tmp_path, monkeypatch):
    """The reference's test_train_checkpoint_resume: a 6-step run then a
    9-step run resume at step 6 and run 3 steps.  And exactly: a 9-step run
    checkpointed every 3 steps and crashed at step 6 resumes at step 6,
    runs only the remaining 3 steps, and ends on the uninterrupted run's
    losses and params bit for bit."""
    kw = dict(seq=16, global_batch=4, ckpt_every=3, device="cpu",
              verbose=False)
    d = str(tmp_path / "ck")
    train_mod.train("internlm2_1_8b", steps=6, ckpt_dir=d, **kw)
    r2 = train_mod.train("internlm2_1_8b", steps=9, ckpt_dir=d, **kw)
    assert len(r2["losses"]) == 3 and np.isfinite(r2["final_loss"])

    full = train_mod.train("internlm2_1_8b", steps=9,
                           ckpt_dir=str(tmp_path / "full"), **kw)
    d2 = str(tmp_path / "crash")
    real = train_mod.data_mod.TokenPipeline.batch

    def crash_at_6(self, step, shard=0):
        if step == 6:
            raise SimulatedCrash("crash before step 6")
        return real(self, step, shard)

    monkeypatch.setattr(train_mod.data_mod.TokenPipeline, "batch",
                        crash_at_6)
    with pytest.raises(SimulatedCrash):
        train_mod.train("internlm2_1_8b", steps=9, ckpt_dir=d2, **kw)
    monkeypatch.setattr(train_mod.data_mod.TokenPipeline, "batch", real)
    resumed = train_mod.train("internlm2_1_8b", steps=9, ckpt_dir=d2, **kw)
    assert len(resumed["losses"]) == 3
    assert resumed["losses"] == full["losses"][6:]
    for a, b in zip(tree_leaves(full["params"]),
                    tree_leaves(resumed["params"])):
        assert torch.equal(a, b)


def test_checkpoint_holds_bf16_params(tmp_path):
    """A bf16 (params, AdamW state) tree saves (as float32, numpy has no
    bfloat16) and restores in its dtypes, bit for bit."""
    from repro_torch.distributed.checkpoint import CheckpointManager
    cfg = _cfg("internlm2_1_8b", dtype="bfloat16")
    params = lm.init_params(lm.make_generator(3, "cpu"), cfg)
    opt = adamw.init_state(params)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, (params, opt))
    like = tree_map(torch.zeros_like, (params, opt))
    (p2, o2), step = mgr.restore(like, device="cpu")
    assert step == 1
    for a, b in zip(tree_leaves((params, opt)),
                    tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
