"""Crash-safe checkpoints of a tree of tensors.

Counterpart of ``repro/distributed/checkpoint.py``, with its on-disk
contract:

  * atomic: write to ``step_<N>.tmp/``, fsync, rename to ``step_<N>/``, so
    a crash mid-write never corrupts the restore set; a fresh manager
    removes stale ``.tmp`` directories
  * async: a background thread (``ckpt-writer``) writes the arrays, so the
    train loop only blocks for the copy to host numpy, which ``save``
    makes once on the calling thread
  * integrity: ``arrays.npz`` carries a crc32 in ``manifest.json``
    (``npz_crc32``, the flattened ``keys``, ``aux_crc32``); restore checks
    it and falls back to the previous step on a mismatch
  * aux payload: ``save(..., aux=...)`` pickles a host object (the
    training cursor, the PlanCache state) next to the arrays with its own
    crc, the recovery contract of the mini-batch loop
    (``train/gnn_steps.py``)

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or Python numbers (the port's params, a list of dicts of tensors,
and its Adam state ``dict(m=, v=, t=)``; the LM's params and AdamW state).
A bfloat16 tensor is stored as float32 (numpy has no bfloat16).  Keys are the reference's:
``"/".join`` of the dict keys and list indices on the path to a leaf,
dict keys in sorted order (``jax.tree_util.tree_flatten_with_path``'s).
A Python int leaf is stored as an int32 scalar, as the reference stores
its Adam step count.  ``restore`` places the arrays on ``device`` in the
dtypes of the tree it is given, or with ``shardings=`` (the elastic
re-mesh path, ``distributed/elastic.py``) each through its
``launch.sharding.NamedSharding``.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import Telemetry

__all__ = ["CheckpointManager"]


def _flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """``[(key, leaf)]`` in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def _map_leaves(tree, fn: Callable, prefix: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn("/".join(str(p) for p in prefix), tree)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            # numpy has no bfloat16: float32 holds every value exactly,
            # and restore casts back to the tree's dtype
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True,
                 telemetry: Telemetry | None = None):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self.tele = telemetry if telemetry is not None else Telemetry()
        self._saves = self.tele.metrics.counter("checkpoint.saves")
        self._write_s = self.tele.metrics.histogram("checkpoint.write_s")
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)
        # a crash mid-write leaves a step_<N>.tmp/ behind; it was never
        # renamed, so it is no restore candidate: remove it (no writer of
        # this manager is live yet)
        for name in os.listdir(directory):
            if re.fullmatch(r"step_\d+\.tmp", name):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, aux: Any = None,
             blocking: bool = False) -> None:
        """Copy ``tree`` to host numpy here, then write it (and ``aux``) as
        step ``step``: on the ``ckpt-writer`` thread, or before returning
        with ``blocking`` or ``async_write=False``."""
        flat = [(k, _to_host(v)) for k, v in _flatten_with_paths(tree)]
        self.wait()   # never two writers
        if self.async_write and not blocking:
            self._thread = threading.Thread(
                target=self._write_caught, args=(step, flat, aux),
                daemon=True, name="ckpt-writer")
            self._thread.start()
        else:
            self._write(step, flat, aux)

    def wait(self) -> None:
        """Join the writer; re-raise what made its write fail."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _write_caught(self, step: int, flat: list, aux: Any) -> None:
        try:
            self._write(step, flat, aux)
        except BaseException as e:   # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, flat: list, aux: Any = None) -> None:
        t0 = time.perf_counter()
        with self.tele.tracer.span("checkpoint.write", cat="io", step=step):
            self._write_inner(step, flat, aux)
        self._saves.inc()
        self._write_s.observe(time.perf_counter() - t0)

    def _write_inner(self, step: int, flat: list, aux: Any = None) -> None:
        tmp = os.path.join(self.dir, f"step_{step:012d}.tmp")
        final = os.path.join(self.dir, f"step_{step:012d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "arrays": {}}
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **dict(flat))
        with open(os.path.join(tmp, "arrays.npz"), "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["npz_crc32"] = crc
        manifest["keys"] = [k for k, _ in flat]
        if aux is not None:
            blob = pickle.dumps(aux, protocol=pickle.HIGHEST_PROTOCOL)
            with open(os.path.join(tmp, "aux.pkl"), "wb") as f:
                f.write(blob)
            manifest["aux_crc32"] = zlib.crc32(blob)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _valid(self, step: int) -> bool:
        d = os.path.join(self.dir, f"step_{step:012d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            with open(os.path.join(d, "arrays.npz"), "rb") as f:
                crc = zlib.crc32(f.read())
            if crc != manifest["npz_crc32"]:
                return False
            if "aux_crc32" in manifest:
                with open(os.path.join(d, "aux.pkl"), "rb") as f:
                    if zlib.crc32(f.read()) != manifest["aux_crc32"]:
                        return False
            return True
        except (OSError, KeyError, json.JSONDecodeError):
            return False

    def latest_valid_step(self) -> int | None:
        for s in reversed(self.all_steps()):
            if self._valid(s):
                return s
        return None

    def _step_or_latest(self, step: int | None) -> int:
        if step is None:
            step = self.latest_valid_step()
            if step is None:
                raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        return step

    def load_aux(self, step: int | None = None) -> Any:
        """Unpickle the aux payload saved with ``step`` (latest valid step
        when None); None when the checkpoint carries no aux.  The payload
        is this program's own pickle, crc-checked by ``_valid``."""
        step = self._step_or_latest(step)
        path = os.path.join(self.dir, f"step_{step:012d}", "aux.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def restore(self, tree_like: Any, step: int | None = None,
                device: str | torch.device = DEFAULT_DEVICE,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of ``tree_like``: tensor leaves in
        their dtypes on ``device`` or, with ``shardings`` (a tree of
        ``NamedSharding`` matching ``tree_like`` leaf for leaf), each
        placed through its sharding (``NamedSharding.place``, which raises
        where it cannot place); Python numbers as their type."""
        if shardings is None:
            dev = resolve_device(device)
            place = None
        else:
            place = dict(_flatten_with_paths(shardings))
            keys = {k for k, _ in _flatten_with_paths(tree_like)}
            if set(place) != keys:
                raise ValueError("shardings and the tree differ at the "
                                 f"leaves {sorted(set(place) ^ keys)}")
        step = self._step_or_latest(step)
        d = os.path.join(self.dir, f"step_{step:012d}")
        with np.load(os.path.join(d, "arrays.npz")) as data:
            def leaf(key, like):
                arr = data[key]
                shape = (tuple(like.shape) if hasattr(like, "shape")
                         else ())
                if arr.shape != shape:
                    raise ValueError(f"checkpoint {key!r}: shape "
                                     f"{arr.shape}, expected {shape}")
                if isinstance(like, torch.Tensor):
                    if place is not None:
                        return place[key].place(
                            torch.from_numpy(arr).to(like.dtype))
                    return torch.from_numpy(arr).to(dev, like.dtype)
                if isinstance(like, np.ndarray):
                    return arr.astype(like.dtype)
                return type(like)(arr)

            return _map_leaves(tree_like, leaf), step
