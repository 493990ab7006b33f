"""Shared set-up of the port's parity tests (``tests/test_torch_*.py``).

Every port test file imports this module first.  It pins PyTorch to one
intra-op thread: the port's tests run beside the JAX suite in several
pytest-xdist workers, and torch's default (one thread per core in every
worker) would oversubscribe the machine.  It sets nothing else: no
environment variable, default dtype or device, or global seed.

Inputs are made with numpy from explicit seeds and handed to both
packages; JAX arrays come back through ``np.asarray``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the reference's float32 kernel tolerance (tests/test_fused.py)
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def assert_bytes_equal(ref, port) -> None:
    """Same dtype, shape and bytes (numpy, JAX or torch arrays)."""
    if isinstance(port, torch.Tensor):
        port = port.detach().cpu().numpy()
    a, b = np.asarray(ref), np.asarray(port)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def assert_close(ref, port, **tol) -> None:
    if isinstance(port, torch.Tensor):
        port = port.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               **(tol or F32_TOL))


def random_edges(n: int, e: int, seed: int, block: int | None = None,
                 spread: int = 0):
    """Deduplicated random (rows, cols, vals).  With ``block`` the columns
    stay within ``spread`` blocks of the row's block, so blocked formats
    get a few dense neighbourhoods instead of scattered single edges."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    if block is None:
        cols = rng.integers(0, n, e)
    else:
        off = rng.integers(-spread, spread + 1, e) * block
        cols = np.clip((rows // block) * block + off
                       + rng.integers(0, block, e), 0, n - 1)
    key = rows.astype(np.int64) * n + cols
    _, keep = np.unique(key, return_index=True)
    rows, cols = rows[keep].astype(np.int32), cols[keep].astype(np.int32)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals


@functools.lru_cache(maxsize=None)
def ref_graph(name: str = "pubmed", scale: float = 0.03, comm_size: int = 8,
              max_feat: int = 32, seed: int = 0):
    """A small reference graph (treat as read-only: it is shared)."""
    from repro.graphs import graph as RG
    return RG.synth_dataset(name, scale, seed=seed, comm_size=comm_size,
                            max_feat=max_feat)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided at run
    time, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run `python -m pytest -m cuda "
                    "tests/test_torch_*.py` on a machine with one")
    return torch.device("cuda")
