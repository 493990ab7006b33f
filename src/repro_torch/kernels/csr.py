"""CSR (row-pointer gather + reduce) aggregation: the ``csr`` and
``csr_fused`` registry entries.

Counterpart of ``repro/kernels/csr.py``.  That module is XLA, not Pallas
(a gather and a sorted segment-sum), so the port is plain PyTorch on any
device: the row pointer expands back to per-edge destination rows,
``index_select`` gathers the source features and ``index_add`` reduces
them.  Both functions are differentiable through autograd.  CSR stores
exactly nnz entries, where ELL pads every row to the largest degree.
"""
from __future__ import annotations

import torch

from repro_torch.core import formats
from repro_torch.kernels import ref
from repro_torch.kernels.registry import (DIAG, OFFDIAG, REGISTRY,
                                          KernelSpec, _bytes_el)


def _edge_rows(csr: formats.CSR) -> torch.Tensor:
    """Per-edge destination rows (sorted), expanded from the row pointer."""
    counts = (csr.indptr[1:] - csr.indptr[:-1]).long()
    rows = torch.arange(csr.n_rows, device=csr.indptr.device)
    return torch.repeat_interleave(rows, counts, output_size=csr.nnz)


def _reduce(csr: formats.CSR, msgs: torch.Tensor, dtype) -> torch.Tensor:
    y = torch.zeros((csr.n_rows, msgs.shape[-1]), dtype=msgs.dtype,
                    device=msgs.device)
    return y.index_add(0, _edge_rows(csr), msgs).to(dtype)


def csr_matvec(csr: formats.CSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A_csr @ x: gather the source rows, scale, reduce per row."""
    acc = ref._acc(x)
    msgs = (x.index_select(0, csr.indices.long()).to(acc)
            * csr.vals.to(acc)[:, None])
    return _reduce(csr, msgs, x.dtype)


def _csr_cost(sub, feat_dim, dtype, hw) -> float:
    be = _bytes_el(dtype)
    nnz = sub.stats["nnz"]
    flops = 2.0 * nnz * feat_dim
    # exact-nnz gather (no ELL padding) + row-pointer stream + output
    bytes_ = nnz * (feat_dim * be + 4) + sub.n_rows * (feat_dim * be + 4)
    return max(flops / hw.peak_flops,
               bytes_ / (hw.hbm_bw * hw.gather_eff)) + hw.launch_overhead_s


REGISTRY.register(KernelSpec(
    name="csr",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=lambda coo, coo_t, B, stats: formats.coo_to_csr(coo),
    matvec=csr_matvec,
    cost=_csr_cost,
    doc="row-pointer gather + reduce (vertex-parallel, exact-nnz storage)",
))


def csr_transform_matvec(csr: formats.CSR, x: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """Y = A_csr @ (x @ w) with each edge transforming only its gathered
    source row, (E, Fi) @ (Fi, Fo): no (n, Fo) H is formed."""
    acc = ref._acc(x)
    h_e = ((x.index_select(0, csr.indices.long()) @ w).to(acc)
           * csr.vals.to(acc)[:, None])
    return _reduce(csr, h_e, x.dtype)


def _csr_fused_cost(sub, feat_dims, dtype, hw) -> float:
    fin, fout = feat_dims
    be = _bytes_el(dtype)
    nnz = sub.stats["nnz"]
    # transform recompute per edge + gather-class traffic on the input side
    flops = 2.0 * nnz * (fin * fout + fout)
    bytes_ = (nnz * (fin * be + fout * be + 8)
              + sub.n_rows * (fout * be + 4))
    return max(flops / hw.peak_flops,
               bytes_ / (hw.hbm_bw * hw.gather_eff)) + hw.launch_overhead_s


REGISTRY.register(KernelSpec(
    name="csr_fused",
    kinds=frozenset({DIAG, OFFDIAG}),
    build=None,
    payload_of="csr",
    matvec=None,
    fused_matvec=csr_transform_matvec,
    cost=_csr_fused_cost,
    doc="fused CSR A @ (X W): per-edge gathered transform, no (n, F) "
        "intermediate; trades per-edge recompute for the H round-trip",
))
