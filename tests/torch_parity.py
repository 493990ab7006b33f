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

# changes to InternLM2's REDUCED config that reach whisper's
# encoder-decoder, its ``encoder_seq`` and qwen2-vl's M-RoPE, alone and
# beside the MoE, MLA and MTP fields (the cases that raised while those
# families were unported: tests/test_torch_lm.py and
# tests/test_torch_jax_parity.py run each)
MODEL_CHANGES = [
    dict(family="encdec", encoder_layers=2),
    dict(family="encdec", encoder_layers=1, n_experts=4, top_k=2),
    dict(family="encdec", encoder_layers=2, attn_type="mla"),
    dict(mrope_sections=(2, 3, 3)),
    dict(mrope_sections=(4, 2, 2), n_experts=4, top_k=2),
    dict(mrope_sections=(2, 3, 3), n_experts=4, top_k=2,
         n_shared_experts=2),
    dict(encoder_seq=100),
    dict(encoder_seq=3000, attn_type="mla"),
    dict(encoder_seq=750, mtp=True),
    dict(encoder_seq=1, n_experts=4, top_k=2, first_k_dense=1)]


def model_change_batch(cfg, B: int, S: int, seed: int) -> dict:
    """Numpy inputs for a MODEL_CHANGES config: tokens (B, S), and for an
    encoder-decoder model 24 encoder frames (B, 24, d)."""
    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (B, 24, cfg.d_model)).astype(np.float32)
    return out


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


# The LM train step's tolerance: gradients, losses and metrics at float32
# rtol 1e-4, atol 1e-5.  Updated params the same, plus what each element's
# Adam direction differs by (AdamSlack): Adam divides m_hat by sqrt(v_hat)
# + eps, so an element whose gradient is small beside the rounding of the
# sums that make it (a cancellation of terms 1e3-1e5 times larger) can
# step in another direction in two right computations, up to 2 lr a step,
# while its gradient agrees at the gradient tolerance.
TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8


class AdamSlack:
    """Each element's slack for a comparison of two runs of AdamW from
    equal params: the sum over steps of lr_t |u_a - u_b|, u = m_hat /
    (sqrt(v_hat) + eps) computed in float64 from each run's own moments
    after step t (``step``: lists of float32 numpy leaves, the optimizer's
    m and v).  ``check`` holds the params to TRAIN_TOL plus that slack,
    and names each element outside it with its |g| (the first step's, from
    m) and its slack."""

    def __init__(self):
        self.t = 0
        self.slack = None
        self.g1 = None

    def step(self, m_a, v_a, m_b, v_b, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - ADAM_B1 ** self.t, 1 - ADAM_B2 ** self.t

        def u(m, v):
            m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
            return (m / c1) / (np.sqrt(v / c2) + ADAM_EPS)

        d = [lr * np.abs(u(ma, va) - u(mb, vb))
             for ma, va, mb, vb in zip(m_a, v_a, m_b, v_b)]
        if self.slack is None:
            self.slack = d
            self.g1 = [np.abs(np.asarray(m, np.float64)) / (1 - ADAM_B1)
                       for m in m_a]
        else:
            self.slack = [s + x for s, x in zip(self.slack, d)]

    def check(self, want_leaves, got_leaves, names, what: str) -> None:
        for name, a, b, slack, g1 in zip(names, want_leaves, got_leaves,
                                         self.slack, self.g1):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            err = np.abs(b - a)
            lim = (TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * np.abs(a)
                   + 1.01 * slack)
            bad = err > lim
            assert not bad.any(), (
                f"{what} {name}: {int(bad.sum())} elements outside "
                f"{TRAIN_TOL} + their Adam slack, " + ", ".join(
                    f"{tuple(int(j) for j in i)} want {a[tuple(i)]:.7g} got "
                    f"{b[tuple(i)]:.7g} |g| {g1[tuple(i)]:.3g} slack "
                    f"{slack[tuple(i)]:.3g}" for i in np.argwhere(bad)[:5]))
