"""The port's mini-batch path on the CPU, torch and numpy only: the
samplers (sampling/sampler.py), the PlanCache and fix_shapes
(sampling/plan_cache.py), the budget-capped blocked-ELL and tcgnn payloads
(core/formats.py, kernels/registry.py, kernels/tcgnn_tile.py) and
train/gnn_steps.py.  Parity with the JAX reference is in
tests/test_torch_jax_parity.py; the CUDA kernels on these payloads are in
tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import decompose as TD
from repro_torch.core import formats as TF
from repro_torch.core import gnn as TGNN
from repro_torch.core.plan import KernelPlan
from repro_torch.distributed import FaultPlan
from repro_torch.graphs import graph as TG
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import registry as TR
from repro_torch.kernels import tcgnn_tile as TT
from repro_torch.obs import Telemetry
from repro_torch.sampling import (ClusterSampler, NeighborSampler, PlanCache,
                                  density_signature, fix_shapes,
                                  plan_payload_keys)
from repro_torch.train import gnn_steps


@functools.lru_cache(maxsize=None)
def small_graph(n=128, e=1000, nf=6, nc=3, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    key = src.astype(np.int64) * n + dst
    _, keep = np.unique(key, return_index=True)
    src, dst = src[keep], dst[keep]
    feats = rng.standard_normal((n, nf)).astype(np.float32)
    labels = rng.integers(0, nc, n).astype(np.int32)
    return TG.Graph(n, src, dst, feats, labels, nc)


def cfg_of(**kw):
    base = dict(model="gcn", hidden=8, n_layers=2, comm_size=8,
                sampler="cluster", clusters_per_batch=4, inter_buckets=2,
                reorder="bfs", selector="cost_model", seed=3)
    base.update(kw)
    return TGNN.GNNConfig(**base)


def train(cfg, steps=6, **kw):
    return gnn_steps.train_minibatch(small_graph(), cfg, steps=steps,
                                     device="cpu", **kw)


BATCH_FIELDS = ("nodes", "node_mask", "senders", "receivers", "edge_mask",
                "features", "labels", "target_mask")


def assert_batches_equal(a, b):
    for f in BATCH_FIELDS:
        tp.assert_bytes_equal(getattr(a, f), getattr(b, f))
    assert a.meta == b.meta


SAMPLERS = {
    "cluster": lambda g, s: ClusterSampler(g, block=8, clusters_per_batch=4,
                                           method="bfs", seed=s),
    "neighbor": lambda g, s: NeighborSampler(g, batch_nodes=16,
                                             fanouts=(4, 2), method="bfs",
                                             block=8, seed=s),
}


# --- samplers -----------------------------------------------------------------

@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_sampler_deterministic_per_seed_and_index(kind):
    """Batch i is a function of (seed, i): two samplers of one seed give
    the same stream, built in any order; another seed gives another."""
    g = small_graph()
    a, b, c = (SAMPLERS[kind](g, s) for s in (7, 7, 8))
    tickets = [b.draw() for _ in range(5)]
    built = {t.index: b.build(t) for t in reversed(tickets)}
    for i in range(5):
        assert_batches_equal(a.sample(), built[i])
    other = [c.sample() for _ in range(5)]
    assert any(not np.array_equal(o.nodes, built[i].nodes)
               for i, o in enumerate(other))


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_no_duplicate_draws_across_an_epoch(kind):
    """Draws run without replacement through an epoch (clusters, or seed
    nodes), and a batch straddling the epoch boundary holds no duplicate."""
    g = small_graph()
    s = SAMPLERS[kind](g, 1)
    per_epoch = s.n_clusters if kind == "cluster" else g.n
    width = s.q if kind == "cluster" else s.batch_nodes
    drawn = []
    for _ in range(-(-2 * per_epoch // width)):
        chosen = s.draw().chosen
        assert len(set(chosen.tolist())) == len(chosen)
        drawn.extend(chosen.tolist())
    first = drawn[:per_epoch]
    assert sorted(first) == list(range(per_epoch))


# --- payload shapes -------------------------------------------------------------

@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_fixed_payload_shapes_across_batches(model):
    """Every batch of one sampler gives the same padded shapes and dtypes
    under one plan (the step's shape record), and fix_shapes pads COO and
    the spills to the edge budget."""
    cfg = cfg_of(model=model, inter_buckets=3)
    g = small_graph()
    sampler = gnn_steps.make_sampler(g, cfg)
    budget = sampler.edge_budget + (sampler.node_budget
                                    if model == "gcn" else 0)
    shapes = set()
    for _ in range(6):
        batch = sampler.sample()
        dec, inv = gnn_steps.prepare_batch(batch, cfg, device=None)
        assert len(dec.subgraphs) == 4
        plan = KernelPlan.make(dec, ("block_diag", "bell", "coo",
                                          "tcgnn_tile"), n_layers=2)
        args = gnn_steps.step_args(batch, dec, inv, plan, budget, tp.CPU)
        shapes.add(gnn_steps.tensor_shapes(args))
        for sub in args[0].subgraphs:
            for key, p in sub.formats.items():
                if key == "coo":
                    assert p.nnz == budget
                elif key in ("bell", "tcgnn_tile"):
                    assert len(p) == 3 and p[2].nnz == budget
    assert len(shapes) == 1


def test_fix_shapes_rejects_an_uncapped_payload():
    """A full-batch (bell, bell_t) pair has data-dependent K: fix_shapes
    refuses it (decompose without an edge budget)."""
    g = small_graph()
    dec = TD.decompose(g, comm_size=8, inter_buckets=1,
                       kernels=("block_diag", "bell"), device="cpu")
    with pytest.raises(TypeError, match="no fixed-shape padding"):
        fix_shapes(dec, 4096)
    budgeted = TD.decompose(g, comm_size=8, inter_buckets=1,
                            kernels=("block_diag", "bell"), edge_budget=4096,
                            device="cpu")
    fixed = fix_shapes(budgeted, 4096, stats=("sig",))
    assert fixed.stats == ("sig",)
    assert all(s.stats is None for s in fixed.subgraphs)


@pytest.mark.parametrize("budget,n_pad,B", [(1, 64, 8), (500, 64, 8),
                                             (4000, 512, 16), (10 ** 6, 96, 8)])
def test_budget_caps_stay_in_their_bounds(budget, n_pad, B):
    nbr = n_pad // B
    k = TF.bell_budget_k(budget, n_pad, B)
    assert 1 <= k <= nbr
    assert k == min(nbr, max(1, -(-2 * budget // (nbr * B))))
    assert TF.bell_budget_k(budget, n_pad, B, slack=4.0) >= k
    c = TT.tcgnn_budget_c(budget, n_pad, B)
    assert c % 128 == 0 and 128 <= c <= max(128, -(-n_pad // 128) * 128)
    assert TT.tcgnn_budget_c(budget, n_pad, B, slack=4.0) >= c


def test_keep_empty_buckets_pins_the_tier_count():
    g = small_graph(n=64, e=40, seed=2)
    for keep in (False, True):
        skel = TD.decompose_skeleton(g, comm_size=8, reorder=False,
                                     inter_buckets=4,
                                     keep_empty_buckets=keep)
        n_inter = len(skel.tiers) - 1
        assert (n_inter == 4) if keep else (n_inter <= 4)
    none = TD.decompose_skeleton(
        TG.Graph(64, np.zeros(0, np.int32), np.zeros(0, np.int32),
                 g.features, g.labels, 3), comm_size=8, reorder=False,
        inter_buckets=3, keep_empty_buckets=True, edge_budget=64)
    assert [t.stats["nnz"] for t in none.tiers] == [0, 0, 0, 0]
    dec = none.materialize(("block_diag", "bell", "tcgnn_tile"),
                           device="cpu")
    x = torch.randn(64, 5)
    for sub in dec.inters:
        for name in ("bell", "tcgnn_tile"):
            y = TR.REGISTRY.get(name).matvec(sub.formats[name], x)
            assert not bool(y.any())


# --- capped payloads against dense products ------------------------------------

def _capped(name, B=8, budget=96, seed=0):
    """A spilling capped payload of random edges (on the CPU, float32)
    and its dense adjacency: blocked-ELL over 128 nodes in a few dense
    neighbourhoods, tcgnn over 512 nodes with about 190 distinct columns
    a block row (its cap C is at least 128)."""
    if name == "bell":
        n = 128
        r, c, v = tp.random_edges(n, 700, seed, block=B, spread=4)
    else:
        n = 512
        r, c, v = tp.random_edges(n, 12000, seed)
    coo = TF.coo_from_edges(n, n, r, c, v)
    build = TR._bell_build if name == "bell" else TT._tcgnn_build
    p = TF.to_device(build(coo, None, B, {"edge_budget": budget}), tp.CPU)
    a = np.zeros((n, n), np.float32)
    a[r, c] = v
    return p, torch.from_numpy(a)


@pytest.mark.parametrize("name", ["bell", "tcgnn_tile"])
def test_capped_payload_matvecs_match_a_dense_product(name):
    """The capped (payload, transpose, spill) triple's plain matvec and
    fused matvec (each also accumulating) against A @ x and A @ (x @ w),
    values and the gradients of x, w and y_in: the spill's gradient is
    counted once, beside the kernels' own."""
    p, a = _capped(name)
    assert p[2].nnz > 0 and p[0].budgeted
    spec = TR.REGISTRY.get(name)
    fspec = TR.REGISTRY.get(name + "_fused")
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn((a.shape[1], 5), generator=gen)
    w0 = torch.randn((5, 3), generator=gen)
    y0 = torch.randn((a.shape[0], 3), generator=gen)
    cot = torch.randn((a.shape[0], 3), generator=gen)
    cases = {
        "matvec": (lambda x, w, y: spec.matvec(p, x @ w),
                   lambda x, w, y: a @ (x @ w)),
        "matvec_acc": (lambda x, w, y: spec.matvec_acc(p, x @ w, y),
                       lambda x, w, y: a @ (x @ w) + y),
        "fused": (lambda x, w, y: fspec.fused_matvec(p, x, w),
                  lambda x, w, y: a @ (x @ w)),
        "fused_acc": (lambda x, w, y: fspec.fused_matvec_acc(p, x, w, y),
                      lambda x, w, y: a @ (x @ w) + y),
    }
    for what, (got_fn, want_fn) in cases.items():
        outs = []
        for fn in (got_fn, want_fn):
            leaves = [t.clone().requires_grad_() for t in (x0, w0, y0)]
            y = fn(*leaves)
            (y * cot).sum().backward()
            outs.append([y.detach()] + [t.grad if t.grad is not None
                                        else torch.zeros_like(t)
                                        for t in leaves])
        for g, w in zip(*outs):
            tp.assert_close(w, g)


def test_coo_transform_matvec_matches_gather_then_scatter():
    r, c, v = tp.random_edges(40, 150, 3)
    coo = TF.to_device(TF.coo_from_edges(40, 40, r, c, v), tp.CPU)
    x = torch.randn(40, 6, dtype=torch.float32)
    w = torch.randn(6, 4)
    tp.assert_close(TOPS.coo_matvec(coo, x @ w),
                    TOPS.coo_transform_matvec(coo, x, w))
    got = TOPS.coo_transform_matvec(coo, x.bfloat16(), w.bfloat16())
    assert got.dtype == torch.bfloat16


# --- PlanCache --------------------------------------------------------------------

def _cache_inputs(model="gcn", e=1000, seed=0):
    cfg = cfg_of(model=model)
    g = small_graph(e=e, seed=seed)
    dec, _ = gnn_steps.prepare_batch(gnn_steps.make_sampler(g, cfg).sample(),
                                     cfg, device=None)
    return cfg, dec, TGNN.agg_width_pairs(cfg, g.features.shape[-1],
                                          g.n_classes)


def test_plan_cache_hit_miss_near_hit_and_eviction():
    cfg, dec, pairs = _cache_inputs()
    cache = PlanCache(pairs, device="cpu")
    plan1, hit1 = cache.plan_for(dec)
    plan2, hit2 = cache.plan_for(dec)
    assert not hit1 and hit2 and plan2 is plan1
    assert cache.stats == dict(hits=1, near_hits=0, misses=1, entries=1,
                               evictions=0, probes=0, hit_rate=0.5,
                               quarantined=0)
    assert cache.select(dec).layers == plan1.layers
    # a lookup off the skeleton's stats alone hits the same entry
    skel_sig = density_signature(dec)
    assert cache.signature(dec) == skel_sig
    # near-hit: a re-keyed entry still matches the resident anchor
    near = PlanCache(pairs, device="cpu")
    plan_a, _ = near.plan_for(dec)
    entry = near._entries.pop(near.signature(dec))
    near._entries[("boundary-neighbor",)] = entry
    plan_b, hit = near.plan_for(dec)
    assert hit and plan_b is plan_a and near.near_hits == 1
    _, hit = near.plan_for(dec)
    assert hit and near.hits == 1
    # a much denser graph misses; a one-entry LRU evicts
    _, dec2, _ = _cache_inputs(e=4000, seed=3)
    assert cache.signature(dec2) != cache.signature(dec)
    tiny = PlanCache(pairs, max_entries=1, device="cpu")
    tiny.plan_for(dec)
    tiny.plan_for(dec2)
    _, hit = tiny.plan_for(dec)
    assert not hit and tiny.stats["evictions"] == 2


def test_plan_cache_probes_on_the_nth_miss():
    cfg, dec, pairs = _cache_inputs(model="gin")
    probing = PlanCache(pairs, probe_every=1, probe_iters=1,
                        edge_budget=4096, device="cpu",
                        telemetry=Telemetry(enabled=True))
    plan, hit = probing.plan_for(dec)
    assert not hit and probing.stats["probes"] == 1
    assert [len(layer) for layer in plan.layers] == [len(dec.subgraphs)] * 2
    plan2, hit2 = probing.plan_for(dec)
    assert hit2 and plan2 is plan and probing.stats["probes"] == 1
    events = probing.tele.audit.events()
    assert any(e["event"] == "probe" for e in events)
    assert [e["source"] for e in events if e["event"] == "plan"] == ["probe"]
    every2 = PlanCache(pairs, probe_every=2, probe_iters=1, device="cpu")
    for _ in range(3):
        every2._entries.clear()
        every2.plan_for(dec)
    assert every2.stats["misses"] == 3 and every2.stats["probes"] == 1


def test_slack_ladder_is_capped_by_max_ladder_recompiles():
    pairs = [(4, 8), (8, 3)]

    def spill_hard(cache, n=6):
        for _ in range(n):
            cache._spill_window.extend([(0.5, 0.9)] * cache.spill_min_obs)
            cache._maybe_step_slack()

    capped = PlanCache(pairs, adapt_budget_k=True, bell_slack=1.0,
                       spill_min_obs=4, max_slack_changes=2, device="cpu")
    spill_hard(capped)
    assert capped.slack_changes == 2 and capped.bell_slack == 2.0
    spill_hard(capped)
    assert capped.slack_changes == 2 and len(capped._spill_window) == 0
    free = PlanCache(pairs, adapt_budget_k=True, bell_slack=1.0,
                     spill_min_obs=4, device="cpu")
    spill_hard(free)
    assert free.slack_changes > 2
    # nothing spills and slots are mostly pad: the ladder steps down
    down = PlanCache(pairs, adapt_budget_k=True, bell_slack=3.0,
                     spill_min_obs=2, device="cpu")
    down._spill_window.extend([(0.0, 0.1)] * 2)
    down._maybe_step_slack()
    assert down.bell_slack == 2.0
    res = train(cfg_of(adapt_budget_k=True, max_ladder_recompiles=1),
                steps=6, eval_batches=0)
    assert res.plan_cache.max_slack_changes == 1
    assert res.cache["slack_changes"] <= 1
    assert "bell_slack" in res.cache and "spill_frac" in res.cache


def test_plan_cache_state_round_trips(tmp_path):
    cfg, dec, pairs = _cache_inputs()
    cache = PlanCache(pairs, device="cpu")
    cache.plan_for(dec)
    cache.quarantine(cache.signature(dec), {"bell", "coo"})
    path = str(tmp_path / "cache.bin")
    cache.save(path)
    fresh = PlanCache(pairs, device="cpu")
    assert fresh.load(path)
    assert fresh.state_dict() == cache.state_dict()
    assert fresh.quarantined_for(cache.signature(dec)) == {"bell"}
    (tmp_path / "bad.bin").write_bytes(b"junk")
    with pytest.warns(UserWarning):
        assert not PlanCache(pairs, device="cpu").load(
            str(tmp_path / "bad.bin"))


# --- the training loop ------------------------------------------------------------

def test_fixed_selector_is_honored():
    res = train(cfg_of(model="gin", inter_buckets=1, selector="fixed",
                       fixed_kernels=("block_diag", "coo")),
                steps=4, eval_batches=1)
    assert res.plans == [(("block_diag", "coo"),) * 2]
    assert res.cache["misses"] == 0 and all(res.hit_history)
    assert res.plan_history == [res.plans[0]] * 4


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
@pytest.mark.parametrize("sampler", ["cluster", "neighbor"])
def test_one_trace_per_plan(model, sampler):
    """n_traces counts the step's shape records: one per committed plan,
    every later batch matching its plan's record."""
    res = train(cfg_of(model=model, sampler=sampler, batch_nodes=16,
                       fanouts=(4, 2)), steps=6, eval_batches=1)
    assert res.n_traces == len(res.plans) >= 1
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert set(res.plan_history) == set(res.plans)
    assert sum(res.hit_history) + res.cache["misses"] == 6
    assert set(res.stage_seconds) == {"sample", "skeleton", "lookup",
                                      "materialize"}


def test_a_shape_mismatch_raises():
    cfg = cfg_of()
    g = small_graph()
    sampler = gnn_steps.make_sampler(g, cfg)
    batch = sampler.sample()
    dec, inv = gnn_steps.prepare_batch(batch, cfg, device=None)
    plan = KernelPlan.make(dec, ("block_diag", "coo"), n_layers=2)
    budget = sampler.edge_budget + sampler.node_budget
    counters = dict(traces=0)
    step = gnn_steps.make_sampled_step(cfg, plan, counters)
    params = TGNN.init_model(torch.Generator().manual_seed(0), cfg,
                             g.features.shape[1], g.n_classes, "cpu")
    opt = TGNN._adam_init(params)
    args = gnn_steps.step_args(batch, dec, inv, plan, budget, tp.CPU)
    step(params, opt, *args)
    step(params, opt, *args)
    assert counters["traces"] == 1
    bigger = gnn_steps.step_args(batch, dec, inv, plan, budget + 8, tp.CPU)
    with pytest.raises(RuntimeError, match="batch shapes differ"):
        step(params, opt, *bigger)
    infer = gnn_steps.make_infer_step(cfg, plan, counters)
    logits = infer(params, args[0], args[1], args[4])
    assert tuple(logits.shape) == (batch.n, g.n_classes)
    assert counters["traces"] == 2


def test_nonfinite_guard_skips_a_poisoned_batch_and_counts_it(monkeypatch):
    cfg = cfg_of(selector="fixed", fixed_kernels=("block_diag", "bell"))
    clean = train(cfg, steps=4, eval_batches=0)
    real = gnn_steps.step_args
    calls = dict(n=0)

    def poisoned(batch, *a, **kw):
        out = real(batch, *a, **kw)
        calls["n"] += 1
        if calls["n"] == 3:                  # batch index 2
            x = out[1].clone()
            x[0, 0] = float("nan")
            out = (out[0], x) + out[2:]
        return out

    monkeypatch.setattr(gnn_steps, "step_args", poisoned)
    res = train(cfg, steps=4, eval_batches=0)
    assert res.faults["nonfinite_skips"] == 1
    assert np.isnan(res.losses[2])
    assert res.losses[:2] == clean.losses[:2]
    # the skipped batch moved nothing: batch 3 sees batch 1's state, so it
    # differs from the clean run's batch 3 unless the update was a no-op
    calls["n"] = 0
    guard_off = train(dataclasses.replace(cfg, nonfinite_guard=False),
                      steps=4, eval_batches=0)
    assert guard_off.faults["nonfinite_skips"] == 0
    assert np.isnan(guard_off.losses[3])
    assert np.isfinite(res.losses[3])
    # direct: params, moments and t come back as they were
    g = small_graph()
    sampler = gnn_steps.make_sampler(g, cfg)
    batch = sampler.sample()
    dec, inv = gnn_steps.prepare_batch(batch, cfg, device=None)
    plan = KernelPlan.make(dec, cfg.fixed_kernels, n_layers=2)
    step = gnn_steps.make_sampled_step(cfg, plan, dict(traces=0))
    params = TGNN.init_model(torch.Generator().manual_seed(0), cfg,
                             g.features.shape[1], g.n_classes, "cpu")
    opt = TGNN._adam_init(params)
    args = list(real(batch, dec, inv, plan,
                     sampler.edge_budget + sampler.node_budget, tp.CPU))
    args[1] = torch.full_like(args[1], float("inf"))
    p2, o2, loss, finite = step(params, opt, *args)
    assert not finite and p2 is params and o2 is opt and o2["t"] == 0


def test_telemetry_on_and_off_are_bit_identical(tmp_path):
    cfg = cfg_of(probe_every=0)
    off = train(cfg, steps=6, eval_batches=1)
    on = train(dataclasses.replace(
        cfg, telemetry=True, trace_out=str(tmp_path / "t.json"),
        telemetry_out=str(tmp_path / "t.jsonl")), steps=6, eval_batches=1)
    assert on.losses == off.losses
    assert on.plans == off.plans and on.hit_history == off.hit_history
    assert on.cache == off.cache and on.n_traces == off.n_traces
    assert not off.telemetry["enabled"] and on.telemetry["enabled"]
    assert on.telemetry["n_span_events"] > 0
    assert on.telemetry["metrics"]["plan_cache.misses"] == on.cache["misses"]
    assert (tmp_path / "t.json").stat().st_size > 0
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert any('"event": "plan"' in line for line in lines)


def test_minibatch_refuses_gat_and_unported_knobs():
    """GAT is no mini-batch model; a fault_plan with injected kernel
    faults (kernel quarantine) raises, naming ROADMAP section 1 item 7;
    prefetch_depth, ported now, runs the pipeline and gives the sync run's
    batches and losses."""
    with pytest.raises(ValueError, match="gcn/gin/sage"):
        train(cfg_of(model="gat"), steps=1)
    res = train(cfg_of(), steps=2, eval_batches=0)
    one = train(cfg_of(prefetch_depth=1), steps=2, eval_batches=0)
    assert (one.losses, one.plan_history, one.hit_history) == (
        res.losses, res.plan_history, res.hit_history)
    assert one.pipeline["delivered"] == 2 and res.pipeline is None
    with pytest.raises(NotImplementedError, match="ROADMAP section 1 item 7"):
        gnn_steps.train_minibatch(small_graph(), cfg_of(), steps=1,
                                  fault_plan=FaultPlan(
                                      kernel_faults={"bell": "execute"}),
                                  device="cpu")
    assert plan_payload_keys(KernelPlan(
        ("intra", "inter0", "inter1"),
        (("block_diag_fused", "bell_fused", "coo"),))) == (
        frozenset({"block_diag"}), frozenset({"bell"}), frozenset({"coo"}))
    assert res.params[0]["w"].device.type == "cpu"
