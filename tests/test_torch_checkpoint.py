"""The port's crash-safe checkpoints (distributed/checkpoint.py) and
checkpoint/resume of mini-batch training (train/gnn_steps.py) on the CPU,
torch and numpy only: the on-disk contract (atomic rename, crc manifest,
aux payload, keep-k GC, the async writer, stale ``.tmp`` directories), a
run crashed mid-epoch and resumed bit-identical to the uninterrupted run
at prefetch 0 and 3, the checkpoint-free resume, and the counters and
cursor.  The checkpoints' parity with the reference's is in
tests/test_torch_jax_parity.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import gnn as TGNN
from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train import gnn_steps
from test_torch_pipeline import cfg_of, small_graph

WAIT_S = 30.0


def tree():
    return dict(a=torch.arange(12.0).reshape(3, 4),
                nested=dict(b=torch.ones((5,), dtype=torch.int32)))


def manager(tmp_path, **kw):
    kw.setdefault("async_write", False)
    return ckpt_mod.CheckpointManager(str(tmp_path), **kw)


def worker_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("pipeline-", "ckpt-writer"))]


def assert_no_worker_threads():
    deadline = time.monotonic() + WAIT_S
    for t in worker_threads():
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    assert not worker_threads()


# -- the checkpoint manager --------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = manager(tmp_path)
    t = tree()
    mgr.save(3, t, blocking=True)
    restored, step = mgr.restore(t, device="cpu")
    assert step == 3
    assert torch.equal(restored["a"], t["a"])
    assert restored["nested"]["b"].dtype == torch.int32
    assert torch.equal(restored["nested"]["b"], t["nested"]["b"])


def test_checkpoint_corruption_falls_back(tmp_path):
    mgr = manager(tmp_path)
    t = tree()
    mgr.save(1, t, blocking=True)
    mgr.save(2, dict(a=t["a"] + 1, nested=dict(b=t["nested"]["b"] + 1)),
             blocking=True)
    with open(os.path.join(str(tmp_path), "step_000000000002",
                           "arrays.npz"), "ab") as f:
        f.write(b"garbage")
    assert mgr.latest_valid_step() == 1
    restored, step = mgr.restore(t, device="cpu")
    assert step == 1
    assert torch.equal(restored["a"], t["a"])


def test_checkpoint_gc_keeps_k(tmp_path):
    mgr = manager(tmp_path, keep=2)
    for s in range(5):
        mgr.save(s, tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async(tmp_path):
    mgr = manager(tmp_path, async_write=True)
    mgr.save(7, tree())
    mgr.wait()
    assert mgr.latest_valid_step() == 7
    assert mgr.tele.metrics.snapshot()["checkpoint.saves"] == 1
    assert_no_worker_threads()


def test_checkpoint_stale_tmp_ignored_and_gced(tmp_path):
    mgr = manager(tmp_path)
    mgr.save(1, tree(), blocking=True)
    stale = os.path.join(str(tmp_path), "step_000000000009.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "arrays.npz"), "wb") as f:
        f.write(b"partial write")
    assert mgr.all_steps() == [1]
    assert mgr.latest_valid_step() == 1
    mgr2 = manager(tmp_path)
    assert not os.path.exists(stale)
    assert mgr2.latest_valid_step() == 1


def test_checkpoint_aux_roundtrip_keep_and_corruption(tmp_path):
    mgr = manager(tmp_path, keep=2)
    for s in range(5):
        mgr.save(s, tree(), aux=dict(cursor=s, state=(1, ("x",))),
                 blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert mgr.load_aux() == dict(cursor=4, state=(1, ("x",)))
    assert mgr.load_aux(step=3)["cursor"] == 3
    mgr.save(5, tree(), blocking=True)           # no aux on this one
    assert mgr.load_aux(step=5) is None
    with open(os.path.join(str(tmp_path), "step_000000000004",
                           "aux.pkl"), "ab") as f:
        f.write(b"garbage")
    mgr.save(6, tree(), aux=dict(cursor=6), blocking=True)
    os.remove(os.path.join(str(tmp_path), "step_000000000006",
                           "manifest.json"))
    assert mgr.latest_valid_step() == 5          # 6 unreadable, GC'd 4
    with pytest.raises(FileNotFoundError):
        manager(tmp_path / "empty").restore(tree(), device="cpu")


def test_checkpoint_keys_follow_the_reference_scheme(tmp_path):
    """Dict keys sorted, list indices, "/" between; an int leaf is an
    int32 scalar and comes back an int; restore keeps the tree's dtypes,
    places the leaves through shardings= (the elastic path) where they can
    be placed and raises where not, and refuses a shape mismatch."""
    params = [dict(w=torch.ones(2, 3), b=torch.zeros(3))]
    state = dict(params=params, opt=dict(m=[dict(w=torch.ones(2, 3),
                                                 b=torch.ones(3))],
                                         v=[dict(w=torch.ones(2, 3),
                                                 b=torch.ones(3))], t=4))
    mgr = manager(tmp_path)
    mgr.save(1, state, blocking=True)
    with open(tmp_path / "step_000000000001" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert keys == ["opt/m/0/b", "opt/m/0/w", "opt/t", "opt/v/0/b",
                    "opt/v/0/w", "params/0/b", "params/0/w"]
    with np.load(tmp_path / "step_000000000001" / "arrays.npz") as data:
        assert data["opt/t"].dtype == np.int32 and int(data["opt/t"]) == 4
    got, _ = mgr.restore(state, device="cpu")
    assert got["opt"]["t"] == 4 and isinstance(got["opt"]["t"], int)
    assert list(got["params"][0]) == ["w", "b"]  # the tree's own order
    one = mesh_mod.host_local_mesh("cpu")
    placed, step = mgr.restore(state, shardings=tree_map(
        lambda _: sharding.NamedSharding(one, sharding.P()), state))
    assert step == 1 and placed["opt"]["t"] == 4
    for a, b in zip(tree_leaves(placed), tree_leaves(got)):
        assert (a == b if isinstance(a, int) else
                a.device.type == "cpu" and a.dtype == b.dtype
                and torch.equal(a, b))
    with pytest.raises(ValueError, match="abstract"):
        mgr.restore(state, shardings=tree_map(lambda _: sharding.NamedSharding(
            mesh_mod.make_production_mesh(), sharding.P()), state))
    with pytest.raises(ValueError, match="differ at the leaves"):
        mgr.restore(state, shardings=dict(params=tree_map(
            lambda _: sharding.NamedSharding(one, sharding.P()), params)))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(dict(state, params=[dict(w=torch.ones(3, 3),
                                             b=torch.zeros(3))]),
                    device="cpu")


def test_checkpoint_writer_failure_raises_at_wait(tmp_path, monkeypatch):
    mgr = manager(tmp_path, async_write=True)

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write_inner", broken)
    mgr.save(1, tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                   # reported once
    assert_no_worker_threads()


# -- crash-safe checkpoint / resume of mini-batch training -------------------

class Crash(RuntimeError):
    """The test's crash, raised by the sampler's build of one batch."""


def crash_at(monkeypatch, index):
    """Make the sampler's build of batch ``index`` raise :class:`Crash`."""
    real = gnn_steps.make_sampler

    def make(graph, cfg):
        sampler = real(graph, cfg)
        build = sampler.build

        def crashing(ticket):
            if ticket.index == index:
                raise Crash(f"crash at batch {index}")
            return build(ticket)

        sampler.build = crashing
        return sampler

    monkeypatch.setattr(gnn_steps, "make_sampler", make)


def train(cfg, steps, **kw):
    return gnn_steps.train_minibatch(small_graph(), cfg, steps=steps,
                                     device="cpu", **kw)


def assert_resumed_equal(res, ref):
    assert res.losses == ref.losses               # bit for bit
    assert res.hit_history == ref.hit_history
    assert res.plans == ref.plans
    assert res.plan_history == ref.plan_history
    assert res.eval_plans == ref.eval_plans
    assert res.cache == ref.cache                 # every counter
    assert res.spill == ref.spill
    assert res.accuracy == ref.accuracy
    for a, b in zip(res.params, ref.params):
        for k in a:
            assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("prefetch", [0, 3], ids=["sync", "async"])
@pytest.mark.parametrize("changes", [
    dict(selector="cost_model"),
    dict(sampler="neighbor", batch_nodes=16, fanouts=(4, 2),
         adapt_budget_k=True)], ids=["cluster", "neighbor_adapt_budget_k"])
def test_crash_resume_bit_identical(prefetch, changes, tmp_path,
                                    monkeypatch):
    """Crash at batch 7 of 10 (checkpoint every 3), resume from the
    directory: the whole loss curve, hit history, plans, cache counters
    and params are the uninterrupted run's.  n_traces is not compared:
    the resumed run records its plans' shapes anew."""
    cfg = cfg_of(prefetch_depth=prefetch, pipeline_workers=2, seed=7,
                 **changes)
    ref = train(cfg, 10, eval_batches=2)
    ck = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path),
                             checkpoint_every=3)
    with monkeypatch.context() as m:
        crash_at(m, 7)
        with pytest.raises(Crash):
            train(ck, 10, eval_batches=0)
    assert_no_worker_threads()                    # the crash leaked none
    res = train(dataclasses.replace(ck, resume_from=str(tmp_path)), 10,
                eval_batches=2)
    assert res.faults["resumed_at"] == 6          # saved after batch 5
    assert_resumed_equal(res, ref)
    assert res.faults["checkpoints"] == 1         # after batch 8
    assert_no_worker_threads()


def test_resume_at_checkpoint_free_index_replays_everything(tmp_path,
                                                            monkeypatch):
    cfg = cfg_of(seed=7)
    ref = train(cfg, 6, eval_batches=1)
    ck = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path),
                             checkpoint_every=4, resume_from=str(tmp_path))
    with monkeypatch.context() as m:
        crash_at(m, 2)
        with pytest.raises(Crash):
            train(dataclasses.replace(ck, resume_from=""), 6, eval_batches=0)
    with pytest.warns(UserWarning, match="no valid checkpoint"):
        res = train(ck, 6, eval_batches=1)
    assert res.faults["resumed_at"] == -1
    assert_resumed_equal(res, ref)


@pytest.mark.parametrize("prefetch", [0, 3], ids=["sync", "async"])
def test_checkpoint_counters_and_cursor(prefetch, tmp_path):
    cfg = cfg_of(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                 prefetch_depth=prefetch, seed=7)
    res = train(cfg, 6, eval_batches=0)
    assert res.faults["checkpoints"] == 3        # after batches 1, 3, 5
    assert res.telemetry["metrics"]["checkpoint.write_s"]["count"] == 3
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 4, 6]
    assert mgr.latest_valid_step() == 6
    aux = mgr.load_aux()
    assert aux["cursor"] == 6
    assert aux["losses"] == res.losses
    assert aux["hit_history"] == res.hit_history
    assert aux["plan_history"] == res.plan_history
    assert [p.layers for p in aux["plans"]] == res.plans
    assert aux["cache"]["misses"] == res.cache["misses"]
    state, step = mgr.restore(
        dict(params=res.params, opt=TGNN._adam_init(res.params)),
        device="cpu")
    assert step == 6 and state["opt"]["t"] == 6
    for a, b in zip(state["params"], res.params):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert_no_worker_threads()
