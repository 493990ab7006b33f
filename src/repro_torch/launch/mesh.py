"""Device meshes for one device (counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` is an ordered ``shape`` (axis name -> size) and, when it is
concrete, the ``torch.device``s it spans, one per point in row-major
order.  A mesh without devices is abstract: the counterpart of the
reference's 512 fake host devices (``repro/launch/dryrun.py``), on which
``launch/sharding.py`` resolves the production layouts and the dry-run
counts each cell without placing anything.

The port runs on one device and uses no ``torch.distributed`` process
group and no DTensor (a DTensor leaf would not reach the hand kernels,
which take raw pointers).  So a concrete mesh here is as large as the
visible devices allow, as ``jax.make_mesh`` checks, and a leaf is placed
only onto a mesh of one device, whole, as ``jax.device_put`` onto a 1 x 1
mesh places it (``sharding.NamedSharding.place``).

Functions, so importing this module touches no device state.
"""
from __future__ import annotations

import math

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device


class Mesh:
    """``shape``: {axis name: size} in axis order; ``devices``: the
    devices it spans (``math.prod`` of the sizes of them), or None for an
    abstract mesh."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 devices: tuple[torch.device, ...] | None = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {axis_names} repeat a name")
        if any(int(n) < 1 for n in shape):
            raise ValueError(f"mesh shape {shape} has an axis under 1")
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(axis_names, shape)}
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if len(devices) != self.size:
                raise ValueError(f"a {shape} mesh spans {self.size} "
                                 f"devices, {len(devices)} given")
        self.devices = devices

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def __repr__(self) -> str:
        where = ("abstract" if self.abstract
                 else ", ".join(str(d) for d in self.devices))
        return f"Mesh({self.shape}, {where})"


def _visible_devices(device: str | torch.device = DEFAULT_DEVICE
                    ) -> list[torch.device]:
    """The devices of ``device``'s type this process sees: every CUDA
    device, or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str | torch.device = DEFAULT_DEVICE) -> Mesh:
    """A concrete mesh over the first ``prod(shape)`` visible devices of
    ``device``'s type (the elastic entry point: ``distributed/elastic.py``
    builds the mesh its plan names); raises when there are fewer, as
    ``jax.make_mesh`` does."""
    devs = _visible_devices(device)
    n = math.prod(shape)
    if n > len(devs):
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices; "
                         f"{len(devs)} {resolve_device(device).type} "
                         "device(s) visible")
    return Mesh(tuple(shape), tuple(axes), tuple(devs[:n]))


def host_local_mesh(device: str | torch.device = DEFAULT_DEVICE) -> Mesh:
    """The one-device (data, model) = (1, 1) mesh over ``device``: the
    device the port's train loop runs on (the reference spans every local
    device with its data axis)."""
    return Mesh((1, 1), ("data", "model"), (resolve_device(device),))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract 16 x 16 (data, model) single-pod mesh, or 2 x 16 x 16
    (pod, data, model) across two pods: 256 or 512 devices that are not
    there, for resolving layouts and the dry-run."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))
