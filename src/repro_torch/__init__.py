"""PyTorch/CUDA port of the AdaptGear reproduction in ``repro``.

The module tree mirrors ``repro`` so that every module here has one
reference module there.  This package imports ``torch`` and ``numpy``
only: it never imports ``jax`` or ``repro``.  The aggregation kernels of
the main path (``kernels/csrc/*.cu``) are CUDA C++ for Hopper; on a CPU
tensor each wrapper runs its plain PyTorch version instead.

Every entry point that places data takes ``device=`` and defaults to
``"cuda"``: nothing runs on the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    this process has no CUDA device (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
