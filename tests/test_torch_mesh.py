"""The port's mesh tools on the CPU, with torch and numpy only: the
elastic arithmetic, meshes and their errors, logical-axis resolution,
meta-tensor stand-ins, ``restore(shardings=)``, ``launch/train.py`` on a
mesh with an elastic resume, and the meta-tensor dry-run's counts against
a real CPU step and a hand count.  The reference's spec trees and
resolved layouts are compared in tests/test_torch_jax_parity.py; a mesh
on the card in tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.distributed import SimulatedCrash
from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.distributed import elastic
from repro_torch.launch import dryrun, profiles, sharding, specs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import tree_leaves

P = sharding.P
ARCH = "internlm2_1_8b"


@pytest.mark.parametrize("n_max", [1100])
def test_best_mesh_shape_and_plan_rescale_hold_their_rules(n_max):
    """For every fleet of 1..1100 devices: the mesh fits the fleet, keeps
    the model axis at 16 where it can (else the largest power of two that
    fits), splits into two pods from 512 usable devices with an even data
    axis, and the rescaled global batch divides over the data axes."""
    for n in range(1, n_max + 1):
        shape, axes = elastic.best_mesh_shape(n)
        mp = shape[-1]
        assert axes[-1] == "model" and mp == min(16, 2 ** int(math.log2(n)))
        assert math.prod(shape) == (n // mp) * mp <= n
        if math.prod(shape) >= 512 and (n // mp) % 2 == 0:
            assert axes == ("pod", "data", "model") and shape[0] == 2
        else:
            assert axes == ("data", "model")
        for gb in (1, 8, 256, 1000):
            plan = elastic.plan_rescale(n, n, gb)
            n_data = math.prod(plan["mesh_shape"]) // mp
            assert plan["global_batch"] % n_data == 0
            assert plan["lr_scale"] == plan["global_batch"] / gb
            if gb % n_data == 0:
                assert plan["global_batch"] == gb
    assert elastic.plan_rescale(1, 1, 8) == dict(
        mesh_shape=(1, 1), mesh_axes=("data", "model"), global_batch=8,
        lr_scale=1.0)


def test_spec_for_checks_divisibility_and_uses_an_axis_once():
    m = mesh_mod.Mesh((2, 4), ("data", "model"))
    rules = sharding.default_rules(m)
    assert sharding.spec_for((8, 12), ("embed", "mlp"), rules, m) == \
        P("data", "model")
    # 6 % 4: replicated, and counted as a fallback
    assert sharding.spec_for((8, 6), ("embed", "mlp"), rules, m) == \
        P("data", None)
    notes = sharding.count_unsharded_fallbacks(
        dict(w=torch.empty((8, 6), device="meta")), dict(w=("embed", "mlp")),
        m)
    assert notes == ["/w: mlp=6 !% 4 -> replicated"]
    # one mesh axis never twice in a tensor
    assert sharding.spec_for((8, 8), ("mlp", "qkv"), rules, m) == \
        P("model", None)
    # None and unknown names replicate; "layer" maps to nothing
    assert sharding.spec_for((3, 8, 8), ("layer", None, "nope"), rules,
                             m) == P(None, None, None)
    # a tuple target: the batch over (pod, data) on the 3-axis mesh, the
    # axes left after one is used, and only axes the mesh has
    m3 = mesh_mod.Mesh((2, 2, 4), ("pod", "data", "model"))
    r3 = sharding.default_rules(m3)
    assert sharding.spec_for((8, 8), ("batch", None), r3, m3) == \
        P(("pod", "data"), None)
    assert sharding.spec_for((6, 8), ("batch", None), r3, m3) == \
        P(None, None)
    assert sharding.spec_for((8, 8), ("embed", "batch"), r3, m3) == \
        P("data", "pod")
    assert sharding.spec_for((8,), ("batch",), rules, m) == P("data")
    # shard_seq moves decode's KV sequence onto the batch axes
    assert sharding.default_rules(m3, shard_seq=True)["kv_seq"] == \
        ("pod", "data")
    assert sharding.default_rules(m)["kv_seq"] is None


def test_batch_specs_shard_the_batch_dim():
    m = mesh_mod.make_production_mesh()
    meta = specs._meta
    got = sharding.batch_specs(dict(
        tokens=meta((32, 64), torch.int32),
        positions=meta((3, 32, 64), torch.int32),
        pos=meta((), torch.int32), odd=meta((6, 4), torch.float32),
        none=None), m)
    assert {k: v.spec for k, v in got.items()} == dict(
        tokens=P("data", None), positions=P(None, "data", None), pos=P(),
        odd=P(None, None), none=P())
    assert all(v.mesh is m for v in got.values())


def test_mesh_errors_and_placement():
    assert mesh_mod.make_production_mesh().shape == dict(data=16, model=16)
    big = mesh_mod.make_production_mesh(multi_pod=True)
    assert big.abstract and big.size == 512
    assert big.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="needs 2 devices"):
        mesh_mod.make_mesh((2, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="differ in length"):
        mesh_mod.Mesh((2,), ("data", "model"))
    with pytest.raises(ValueError, match="spans 2 devices, 1 given"):
        mesh_mod.Mesh((1, 2), ("data", "model"), ("cpu",))
    x = torch.arange(6.0).reshape(2, 3)
    with pytest.raises(ValueError, match="abstract"):
        sharding.NamedSharding(big, P()).place(x)
    with pytest.raises(ValueError, match="one device"):
        sharding.NamedSharding(mesh_mod.Mesh((2, 1), ("data", "model"),
                                             ("cpu", "cpu")), P()).place(x)
    one = mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
    assert one.devices == (torch.device("cpu"),)
    placed = sharding.NamedSharding(one, P("data", "model")).place(x)
    assert placed.device.type == "cpu" and torch.equal(placed, x)
    with pytest.raises(ValueError, match="dims"):
        sharding.NamedSharding(one, P(None, None, None)).place(x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_mod.host_local_mesh()


def test_meta_params_allocate_nothing():
    """DeepSeek-V3 FULL's 671.7 B parameters (1.34 TB in bf16) as meta
    tensors: every leaf on the meta device in the reference's dtypes,
    and the spec tree resolves over them."""
    cfg = configs.get_config("deepseek_v3_671b")
    p = specs.params_shapes(cfg)
    leaves = tree_leaves(p)
    assert all(a.device.type == "meta" for a in leaves)
    assert sum(a.numel() for a in leaves) == 671_712_655_360
    assert {a.dtype for a in leaves} == {torch.bfloat16, torch.float32}
    moe = p["groups"][-1]["ffn"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_up"].shape == (cfg.n_layers - cfg.first_k_dense, 256,
                                 cfg.d_model, cfg.d_ff_expert)
    opt = specs.opt_state_shapes(cfg)
    assert opt["step"].device.type == "meta"
    assert all(a.dtype == torch.float32 for a in tree_leaves(opt["m"]))
    shards = sharding.tree_shardings(p, lm.param_specs(cfg),
                                     mesh_mod.make_production_mesh())
    assert len(tree_leaves(shards)) == len(leaves)


def test_logical_spec_trees_match_the_params_and_caches():
    """Every FULL config's param_specs and cache_specs have the structure
    of its params and caches, with one name (or None) per dim."""
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        for shapes, logical in (
                (specs.params_shapes(cfg), lm.param_specs(cfg)),
                (specs.decode_specs(cfg, 4096, 8)[0], lm.cache_specs(cfg))):
            pairs = []
            lm._tree_map(lambda a, t: pairs.append((a, t)), shapes, logical,
                         is_leaf=lambda t: t is None)
            # whisper's encoder group has no cache: None in both trees
            assert pairs and all((a is None and t is None) or (
                lm.is_logical(t) and len(t) == a.dim())
                for a, t in pairs), arch


def _reduced(arch: str = ARCH, **changes):
    return dataclasses.replace(configs.get_config(arch, reduced=True),
                               **changes)


def test_restore_onto_shardings_equals_a_plain_restore(tmp_path):
    cfg = _reduced()
    params = lm.init_params(lm.make_generator(1, "cpu"), cfg)
    opt = adamw.init_state(params)
    mgr = ckpt_mod.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, (params, opt))
    one = mesh_mod.host_local_mesh("cpu")
    logical = lm.param_specs(cfg)
    shard = (sharding.tree_shardings(params, logical, one),
             sharding.tree_shardings(opt, adamw.state_specs(logical), one))
    placed, step = mgr.restore((params, opt), shardings=shard)
    plain, _ = mgr.restore((params, opt), device="cpu")
    assert step == 3
    for a, b in zip(tree_leaves(placed), tree_leaves(plain)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_train_on_a_mesh_and_an_elastic_resume_equal_the_plain_run(
        tmp_path, monkeypatch):
    """train(use_mesh=host_local_mesh("cpu")) gives train()'s losses and
    params bit for bit; a run on that mesh crashed at step 3 and resumed
    through the elastic protocol (plan_rescale, make_mesh of its shape,
    restore(shardings=) inside train) ends on the uninterrupted run's."""
    kw = dict(seq=16, global_batch=4, device="cpu", verbose=False)
    plain = train_mod.train(ARCH, steps=6, **kw)
    on_mesh = train_mod.train(ARCH, steps=6, **kw,
                              use_mesh=mesh_mod.host_local_mesh("cpu"))
    assert on_mesh["losses"] == plain["losses"]
    for a, b in zip(tree_leaves(plain["params"]),
                    tree_leaves(on_mesh["params"])):
        assert torch.equal(a, b)

    d = str(tmp_path / "elastic")
    real = train_mod.data_mod.TokenPipeline.batch

    def crash_at_3(self, step, shard=0):
        if step == 3:
            raise SimulatedCrash("crash before step 3")
        return real(self, step, shard)

    monkeypatch.setattr(train_mod.data_mod.TokenPipeline, "batch",
                        crash_at_3)
    with pytest.raises(SimulatedCrash):
        train_mod.train(ARCH, steps=6, ckpt_dir=d, ckpt_every=3, **kw,
                        use_mesh=mesh_mod.host_local_mesh("cpu"))
    monkeypatch.setattr(train_mod.data_mod.TokenPipeline, "batch", real)
    plan = elastic.plan_rescale(1, 1, kw["global_batch"])
    new_mesh = mesh_mod.make_mesh(plan["mesh_shape"], plan["mesh_axes"],
                                  "cpu")
    resumed = train_mod.train(
        ARCH, steps=6, ckpt_dir=d, ckpt_every=3, use_mesh=new_mesh,
        **dict(kw, global_batch=plan["global_batch"]))
    assert resumed["losses"] == plain["losses"][3:]
    for a, b in zip(tree_leaves(plain["params"]),
                    tree_leaves(resumed["params"])):
        assert torch.equal(a, b)


def _real_args(cfg, mode: str, seq: int, batch: int):
    """The count_step inputs as real CPU tensors of the same shapes."""
    rng = np.random.default_rng(0)
    params = lm.init_params(lm.make_generator(0, "cpu"), cfg)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq + 1))
                            .astype(np.int32))
    if mode == "train":
        return (steps.make_train_step(cfg, adamw.OptConfig()),
                (params, adamw.init_state(params),
                 dict(tokens=toks[:, :-1], labels=toks[:, 1:])))
    if mode == "prefill":
        return steps.make_prefill_step(cfg), (params,
                                              dict(tokens=toks[:, :-1]))
    return steps.make_serve_step(cfg), (
        params, lm.init_cache(cfg, batch, seq, device="cpu"), toks[:, :1],
        seq - 1)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_dryrun_counts_equal_a_real_cpu_step(mode):
    """The meta-tensor count of InternLM2 REDUCED's step (remat "dots" in
    training) equals FlopCounterMode and the byte counter over the same
    step on real CPU tensors, exactly."""
    cfg = _reduced(remat="dots")
    got = dryrun.count_step(cfg, mode, 32, 2)
    fn, args = _real_args(cfg, mode, 32, 2)
    with FlopCounterMode(display=False) as flop:
        fn(*args)
    with dryrun.StepCounter() as counter:
        fn(*args)
    assert got["flops"] == flop.get_total_flops() == counter.flops > 0
    assert got["bytes_accessed"] == counter.bytes > 0
    assert got["ops"] == counter.ops


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_dryrun_flops_equal_flop_counter_mode(arch):
    """Every family's REDUCED train step on meta tensors (at 64 x 128:
    8192 tokens put every MoE config on the sparse path): the dry-run's
    one-mode count equals FlopCounterMode's."""
    cfg = _reduced(arch)
    got = dryrun.count_step(cfg, "train", 128, 64)
    args = (specs.params_shapes(cfg), specs.opt_state_shapes(cfg),
            specs.train_batch_specs(cfg, 128, 64))
    with FlopCounterMode(display=False) as flop:
        steps.make_train_step(cfg, adamw.OptConfig())(*args)
    assert got["flops"] == flop.get_total_flops() > 0


def test_dryrun_prefill_count_matches_a_hand_count():
    """InternLM2 REDUCED's prefill: the GEMMs (q, k, v, o, the gated FFN's
    three, the head) and both attention products over the whole S x S
    (the plain core masks, it does not skip), within 1 %."""
    cfg = _reduced()
    B, S = 2, 64
    d, H, KV, dh, ff = (cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
                        cfg.d_ff)
    N = B * S
    per_layer = (2 * N * d * H * dh + 2 * 2 * N * d * KV * dh
                 + 2 * N * H * dh * d + 2 * 2 * B * H * S * S * dh
                 + 3 * 2 * N * d * ff)
    want = cfg.n_layers * per_layer + 2 * N * d * cfg.padded_vocab
    got = dryrun.count_step(cfg, "prefill", S, B)["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    # training: forward, the recompute under remat "dots" adds no product
    # it keeps, and the backward's two products per forward product
    train = dryrun.count_step(cfg, "train", S, B)["flops"]
    assert train >= 3 * got


def test_dryrun_cell_resolves_and_counts_a_reduced_cell(monkeypatch):
    """One cell through dryrun_cell and run() on the single-pod mesh, with
    the REDUCED config standing in for FULL: ok with its counts and no
    collectives; long_500k skipped for full attention; a cell that raises
    is FAILED and main exits 1."""
    real = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name, reduced=False: real(name, reduced=True))
    m = mesh_mod.make_production_mesh()
    monkeypatch.setitem(configs.SHAPES, "train_tiny",
                        dict(seq=32, batch=16, mode="train"))
    r = dryrun.dryrun_cell(ARCH, "train_tiny", m, verbose=False)
    assert r["status"] == "ok" and r["mesh"] == "16x16"
    assert r["n_devices"] == 256 and r["collective_bytes"] is None
    assert r["flops"] == dryrun.count_step(_reduced(), "train", 32,
                                           16)["flops"]
    assert r["memory"]["temp_bytes"] is None
    assert r["memory"]["argument_bytes"] > 0 and r["fallback_notes"] >= 0
    res = dryrun.run([ARCH, "rwkv6_7b"], ["long_500k"], [m], verbose=False)
    assert [x["status"] for x in res] == ["skipped", "ok"]

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "count_step", boom)
    assert dryrun.summary(dryrun.run([ARCH], ["train_tiny"], [m],
                                     verbose=False)) == (0, 0, 1)
    assert dryrun.main(["--arch", ARCH, "--shape", "train_tiny"]) == 1


def test_profiles_price_the_given_memory():
    cfg = configs.get_config("qwen2_5_14b")
    assert profiles.padded_heads(cfg, 16) == dict(n_heads=48, kv_heads=16)
    assert profiles.padded_heads(cfg, 1) == {}
    # 29.5 GB of bf16 weights: a 16th fits half of 80 GB, all of it not
    assert profiles.weights_fit_zero1(cfg, 16, hbm_bytes=80 * 10**9)
    assert not profiles.weights_fit_zero1(cfg, 1, hbm_bytes=40 * 10**9)
    mo, ro = profiles.optimized_overrides(cfg, "train", 16,
                                          hbm_bytes=80 * 10**9)
    assert mo == dict(n_heads=48, kv_heads=16, attn_core="flash")
    assert ro == {"embed": None}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="hbm_bytes"):
            profiles.weights_fit_zero1(cfg, 16)
