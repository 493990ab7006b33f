"""One-device dry-run: every (architecture x input shape) cell of
``configs.ARCHS`` x ``configs.SHAPES`` on the abstract 16 x 16 single-pod
mesh and the 2 x 16 x 16 multi-pod mesh, without allocating a tensor.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell's step on 512 fake host devices and reads XLA's cost analysis.  Here,
for each cell:

  * the parameter, optimizer-state, batch and decode-cache shardings are
    resolved on the abstract mesh (``launch/sharding.py``) and the
    parameters' and caches' fallbacks to replication counted
    (``count_unsharded_fallbacks``);
  * the cell's step (``make_train_step``, ``make_prefill_step`` or
    ``make_serve_step``) runs eagerly on ``meta`` tensors
    (``launch/specs.py``) under one ``TorchDispatchMode``
    (``StepCounter``) that counts ``flops`` by
    ``torch.utils.flop_counter``'s formulas (its ``flop_registry``, what
    ``FlopCounterMode`` sums; tests/test_torch_mesh.py holds the two equal
    on real CPU steps) and ``bytes_accessed``: the sum, over every
    dispatched aten op that is not a view, of the bytes of its tensor
    inputs and outputs (element count times element size, whole
    tensors).  That is the traffic of the unfused eager program, each op
    reading its inputs and writing its outputs once: not XLA's count
    after fusion, and no cache is modelled.

The FLOPs are those of the plain cores: a hand kernel cannot run on meta
tensors, so ``--optimized`` drops the kernel cores from
``profiles.optimized_overrides`` as the reference drops its Pallas cores.
Matrix products and attention are what those formulas count;
elementwise work is not in ``flops``.  Where the train step recomputes
(remat, ``cfg.remat``), the recompute is counted.  The counts are of the
whole (global) step on one device: nothing is divided by the mesh.

``memory`` holds the step's ``argument_bytes`` (params, optimizer state,
batch or caches) and ``output_bytes``; ``temp_bytes`` is None (not
measured on meta tensors).  ``collective_bytes`` is None: a one-device
program has no collectives, so the reference's HLO collective parser has
nothing to read and is not ported.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells, single-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod      # both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/dryrun.json

A cell that raises is ``FAILED`` and the run exits 1.  Host reads of a
device value (``.item()``, ``bool()``) fail on meta tensors; the steps
have none.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import profiles, sharding, specs
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import steps

KERNEL_CORES = ("attn_core", "mamba_core", "wkv_core")
META = torch.device("meta")


def _leaves(obj, out: list) -> list:
    """The values in ``obj`` (nested tuples, lists and dict values) onto
    ``out``, each tuple or list announced by its type and length."""
    if isinstance(obj, (tuple, list)):
        out.append((type(obj), len(obj)))
        for o in obj:
            _leaves(o, out)
    elif isinstance(obj, dict):
        out.append((dict, tuple(obj)))
        for o in obj.values():
            _leaves(o, out)
    else:
        out.append(obj)
    return out


def _tensor_bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(obj, [])
               if isinstance(t, torch.Tensor))


def _fresh_outputs(func) -> bool:
    """Whether ``func`` writes nothing it is given and returns only new
    tensors (no view, no in-place or out= form)."""
    schema = func._schema
    return not (func.is_view or schema.is_mutable or any(
        r.alias_info is not None for r in schema.returns))


def _meta_key(func, args, kwargs):
    """A hashable key of an op on meta tensors: the op, the structure of
    its arguments, each tensor's shape, strides and dtype (a new
    tensor's layout does not depend on where its inputs start in their
    storage), and every other argument; None where an argument is not
    hashable or a tensor is not on the meta device."""
    key = [func]
    for a in _leaves((args, kwargs), []):
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            key.append((a.shape, a.stride(), a.dtype))
        else:
            try:
                hash(a)
            except TypeError:
                return None
            key.append((type(a), a))
    return tuple(key)


def _empty_like_out(out):
    """New meta tensors with the shapes, strides and dtypes of ``out``'s
    tensors, in its structure (tuples and lists; other values as they
    are)."""
    if isinstance(out, torch.Tensor):
        return torch.empty_strided(out.shape, out.stride(), dtype=out.dtype,
                                   device=META)
    if isinstance(out, (tuple, list)):
        return type(out)(_empty_like_out(o) for o in out)
    return out


class StepCounter(TorchDispatchMode):
    """Counts what runs under it: ``flops`` by ``flop_registry`` (matrix
    products, convolutions, attention), and for every aten op that is not
    a view the bytes of its tensor inputs and outputs (``bytes``) and the
    op itself (``ops``).

    On meta tensors an op that returns only new tensors runs its meta
    function once per argument signature (shapes, strides, dtypes and
    other arguments); a repeat gets new meta tensors of the remembered
    outputs' layout without running it (a layer's or a chunk's ops repeat
    thousands of times in a step, and torch's meta functions for
    elementwise ops are Python).  Outputs and counts are the same."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self._outs: dict = {}

    def _run(self, func, args, kwargs):
        key = _meta_key(func, args, kwargs) if _fresh_outputs(func) else None
        if key is None:
            return func(*args, **kwargs)
        out = self._outs.get(key)
        if out is None:
            out = func(*args, **kwargs)
            # a factory op's key names no tensor: keep meta outputs only
            if all(t.device.type == "meta" for t in _leaves(out, [])
                   if isinstance(t, torch.Tensor)):
                # a copy of the layout that the program never holds (it
                # may resize what it is given)
                self._outs[key] = _empty_like_out(out)
            return out
        return _empty_like_out(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.ops += 1
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def count_step(cfg: lm.ModelConfig, mode: str, seq: int, batch: int, *,
               accum: int = 1) -> dict:
    """``cfg``'s step of ``mode`` ("train": ``make_train_step`` with the
    default ``OptConfig`` and ``accum`` micro-batches; "prefill"; "decode":
    one token against a cache of ``seq`` positions, at its last one) run on
    meta tensors at (``batch``, ``seq``): flops, bytes_accessed, the
    number of ops, argument and output bytes, and the seconds it took."""
    t0 = time.perf_counter()
    params = specs.params_shapes(cfg)
    if mode == "train":
        fn = steps.make_train_step(cfg, adamw.OptConfig(), accum_steps=accum)
        args = (params, specs.opt_state_shapes(cfg),
                specs.train_batch_specs(cfg, seq, batch))
    elif mode == "prefill":
        fn = steps.make_prefill_step(cfg)
        args = (params, specs.prefill_batch_specs(cfg, seq, batch))
    elif mode == "decode":
        caches, tokens, _ = specs.decode_specs(cfg, seq, batch)
        fn = steps.make_serve_step(cfg)
        args = (params, caches, tokens, seq - 1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    arg_bytes = _tensor_bytes(args)
    with StepCounter() as counter:
        out = fn(*args)
    return dict(flops=int(counter.flops),
                bytes_accessed=int(counter.bytes), ops=counter.ops,
                argument_bytes=arg_bytes, output_bytes=_tensor_bytes(out),
                trace_s=time.perf_counter() - t0)


def shard_seq_for(mode: str, batch: int, mesh: mesh_mod.Mesh) -> bool:
    """Long-context decode whose batch cannot fill the batch mesh axes
    shards the KV/sequence axis over them instead (the reference's
    rule)."""
    n_batch = 1
    for a in mesh.axis_names:
        if a != "model":
            n_batch *= mesh.shape[a]
    return mode == "decode" and batch < n_batch


def resolve_cell(cfg: lm.ModelConfig, mode: str, seq: int, batch: int,
                 mesh: mesh_mod.Mesh, rules: dict) -> dict:
    """The cell's shardings on ``mesh`` (params, optimizer state, batch
    or caches and token) and the fallback notes of params and caches."""
    p_shapes, p_logical = specs.params_shapes(cfg), lm.param_specs(cfg)
    out = dict(params=sharding.tree_shardings(p_shapes, p_logical, mesh,
                                              rules))
    notes = sharding.count_unsharded_fallbacks(p_shapes, p_logical, mesh,
                                               rules)
    if mode == "train":
        out["opt_state"] = dict(m=out["params"], v=out["params"],
                                step=sharding.NamedSharding(
                                    mesh, sharding.P()))
        out["batch"] = sharding.batch_specs(
            specs.train_batch_specs(cfg, seq, batch), mesh, rules)
    elif mode == "prefill":
        out["batch"] = sharding.batch_specs(
            specs.prefill_batch_specs(cfg, seq, batch), mesh, rules)
    else:
        caches, tokens, _ = specs.decode_specs(cfg, seq, batch)
        c_logical = lm.cache_specs(cfg)
        out["caches"] = sharding.tree_shardings(caches, c_logical, mesh,
                                                rules)
        out["tokens"] = sharding.batch_specs(dict(t=tokens), mesh,
                                             rules)["t"]
        notes += sharding.count_unsharded_fallbacks(caches, c_logical,
                                                    mesh, rules)
    out["notes"] = notes
    return out


def dryrun_cell(arch: str, shape_name: str, mesh: mesh_mod.Mesh, *,
                verbose: bool = True, model_overrides: dict | None = None,
                rules_overrides: dict | None = None) -> dict:
    cfg = configs.get_config(arch)
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    ok, reason = configs.shape_applicable(cfg, shape_name)
    if not ok:
        return dict(arch=arch, shape=shape_name, status="skipped",
                    reason=reason)
    sh = configs.SHAPES[shape_name]
    mode, seq, batch = sh["mode"], sh["seq"], sh["batch"]
    t0 = time.perf_counter()
    rules = sharding.default_rules(
        mesh, shard_seq=shard_seq_for(mode, batch, mesh))
    if rules_overrides:
        rules.update(rules_overrides)
    resolved = resolve_cell(cfg, mode, seq, batch, mesh, rules)
    t_resolve = time.perf_counter() - t0
    c = count_step(cfg, mode, seq, batch)
    result = dict(
        arch=arch, shape=shape_name, status="ok", mode=mode,
        mesh="x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        n_devices=mesh.size, flops=c["flops"],
        bytes_accessed=c["bytes_accessed"], ops=c["ops"],
        collective_bytes=None,
        fallback_notes=len(resolved["notes"]),
        resolve_s=round(t_resolve, 3), trace_s=round(c["trace_s"], 3),
        memory=dict(argument_bytes=c["argument_bytes"],
                    output_bytes=c["output_bytes"], temp_bytes=None))
    if verbose:
        _print_cell(result)
    return result


def _cell_job(arch: str, shape: str, mesh: mesh_mod.Mesh, optimized: bool,
              hbm_bytes: int | None) -> tuple[dict, str]:
    """One cell, its failure caught: (result, traceback text or "")."""
    try:
        mo, ro = None, None
        if optimized:
            mo, ro = profiles.optimized_overrides(
                configs.get_config(arch), configs.SHAPES[shape]["mode"],
                mesh.shape["model"], hbm_bytes=hbm_bytes)
            # kernel cores cannot run on meta tensors: keep the plain cores
            mo = {k: v for k, v in mo.items() if k not in KERNEL_CORES}
        return dryrun_cell(arch, shape, mesh, verbose=False,
                           model_overrides=mo, rules_overrides=ro), ""
    except Exception as e:  # a failure is a bug in the port
        return dict(arch=arch, shape=shape, mesh=str(mesh.shape),
                    status="FAILED", error=str(e)[-2000:]), \
            traceback.format_exc()


def _trace_cost(arch: str, shape: str) -> int:
    """A rough count of the ops a cell's trace dispatches: layers, times
    RWKV-6's chunks (its plain core loops over them), three times for a
    train step (forward, recompute, backward)."""
    cfg = configs.get_config(arch)
    sh = configs.SHAPES[shape]
    cost = cfg.n_layers + cfg.encoder_layers
    if cfg.layer_pattern == "rwkv" and sh["mode"] != "decode":
        cost *= sh["seq"] // cfg.rwkv_chunk
    return cost * (3 if sh["mode"] == "train" else 1)


def _print_cell(r: dict) -> None:
    if r["status"] == "ok":
        print(f"  {r['arch']:20s} {r['shape']:12s} mesh={r['mesh']:8s} "
              f"flops={r['flops']:.3e} bytes={r['bytes_accessed']:.3e} "
              f"notes={r['fallback_notes']} resolve={r['resolve_s']:.2f}s "
              f"trace={r['trace_s']:.2f}s", flush=True)
    elif r["status"] == "skipped":
        print(f"  {r['arch']:20s} {r['shape']:12s} skipped: {r['reason']}",
              flush=True)


def spawn_pool(workers: int):
    """A pool of ``workers`` spawned processes (no fork: the parent may
    hold a CUDA context and threads) for ``run``."""
    import concurrent.futures as cf
    import multiprocessing as mp
    return cf.ProcessPoolExecutor(max_workers=workers,
                                  mp_context=mp.get_context("spawn"),
                                  initializer=torch.set_num_threads,
                                  initargs=(1,))


def run(archs, shapes, meshes, *, optimized: bool = False,
        hbm_bytes: int | None = None, pool=None,
        verbose: bool = True) -> list[dict]:
    """``dryrun_cell`` over archs x shapes on each mesh, in this process
    or on ``pool`` (an executor: each cell is independent host work); a
    cell that raises is recorded ``FAILED`` with its error.  Results in
    (mesh, arch, shape) order."""
    jobs = [(arch, shape, mesh, optimized, hbm_bytes)
            for mesh in meshes for arch in archs for shape in shapes]
    if pool is not None:
        # the longest traces first, so no worker starts one last
        futures = {i: pool.submit(_cell_job, *jobs[i]) for i in sorted(
            range(len(jobs)), key=lambda i: -_trace_cost(*jobs[i][:2]))}
        done = [futures[i].result() for i in range(len(jobs))]
    else:
        done = [_cell_job(*job) for job in jobs]
    results, last = [], None
    for (arch, shape, mesh, *_), (r, tb) in zip(jobs, done):
        if verbose and mesh is not last:
            print(f"== mesh {mesh.shape} ==", flush=True)
            last = mesh
        if tb:
            print(tb, flush=True)
        if verbose:
            _print_cell(r)
        results.append(r)
    return results


def summary(results: list[dict]) -> tuple[int, int, int]:
    """(ok, skipped, FAILED) counts."""
    return tuple(sum(r["status"] == s for r in results)
                 for s in ("ok", "skipped", "FAILED"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="also run the 2x16x16 multi-pod mesh")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the launcher profile (head padding, "
                         "size-adaptive ZeRO-1; kernel cores dropped)")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="device memory for --optimized's ZeRO-1 rule "
                         "(default: the CUDA device's)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes the cells are spread over")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ([configs.canonical(args.arch)] if args.arch
             else configs.ARCHS)
    shapes = [args.shape] if args.shape else list(configs.SHAPES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(mesh_mod.make_production_mesh(multi_pod=False))
    if args.multi_pod or args.multi_pod_only:
        meshes.append(mesh_mod.make_production_mesh(multi_pod=True))

    kw = dict(optimized=args.optimized, hbm_bytes=args.hbm_bytes)
    if args.workers > 1:
        with spawn_pool(args.workers) as pool:
            results = run(archs, shapes, meshes, pool=pool, **kw)
    else:
        results = run(archs, shapes, meshes, **kw)
    n_ok, n_skip, n_fail = summary(results)
    print(f"\n== dry-run summary: {n_ok} ok / {n_skip} skipped / "
          f"{n_fail} FAILED ==")
    for r in results:
        if r["status"] == "FAILED":
            print(f"  FAILED {r['arch']} {r['shape']}: {r['error'][:300]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
