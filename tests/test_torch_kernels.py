"""The port's kernel wrappers on the CPU: CPU tensors run the plain
version and launch nothing, bad operands raise, and the build targets
Hopper.  The plain versions' parity with the reference's Pallas kernels is
in tests/test_torch_jax_parity.py; the CUDA kernels are checked on the
card by tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.core import formats as TF
from repro_torch.kernels import _build
from repro_torch.kernels import bell_spmm as bell_mod
from repro_torch.kernels import bell_spmm_fused as bellf_mod
from repro_torch.kernels import block_diag_spmm as bd_mod
from repro_torch.kernels import block_diag_spmm_fused as bdf_mod


def _block_diag_inputs(B: int, F: int, seed: int, nb: int = 4):
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((nb, B, B)).astype(np.float32)
    x = rng.standard_normal((nb * B, F)).astype(np.float32)
    y_in = rng.standard_normal((nb * B, F)).astype(np.float32)
    return blocks, x, y_in


def _bell_inputs(B: int, F: int, seed: int, n: int = 96):
    """A placed blocked-ELL payload (with padding slots) and an x."""
    r, c, v = tp.random_edges(n, 260, seed, block=B, spread=2)
    bell = TF.to_device(TF.coo_to_bell(TF.coo_from_edges(n, n, r, c, v), B),
                        tp.CPU)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((bell.n_cols, F)).astype(np.float32)
    return bell, x


def test_cpu_tensors_run_the_plain_version_without_launching():
    blocks, x, y_in = _block_diag_inputs(8, 6, seed=4)
    bell, bx = _bell_inputs(8, 6, seed=4)
    assert int(bell.n_valid.min()) < bell.max_blocks     # has padding
    before = (bd_mod.launches.value, bell_mod.launches.value)
    got = bd_mod.block_diag_spmm(torch.from_numpy(blocks),
                                 torch.from_numpy(x), torch.from_numpy(y_in))
    want = bd_mod.plain(torch.from_numpy(blocks), torch.from_numpy(x),
                        torch.from_numpy(y_in))
    assert torch.equal(got, want)
    got = bell_mod.bell_spmm(bell.blocks, bell.col_idx, torch.from_numpy(bx),
                             n_valid=bell.n_valid)
    assert torch.equal(got, bell_mod.plain(bell.blocks, bell.col_idx,
                                           torch.from_numpy(bx)))
    assert (bd_mod.launches.value, bell_mod.launches.value) == before


def test_cpu_tensors_run_the_training_kernels_plain_without_launching():
    blocks, x, _ = _block_diag_inputs(8, 6, seed=5)
    bell, bx = _bell_inputs(8, 6, seed=5)
    blocks, x, bx = map(torch.from_numpy, (blocks, x, bx))
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (6, 4)).astype(np.float32))
    counts = (bdf_mod.launches, bellf_mod.launches, bellf_mod.dw_launches,
              bd_mod.launches)
    before = [c.value for c in counts]
    cases = [
        (bd_mod.block_diag_spmm(blocks, x, transpose=True),
         bd_mod.plain(blocks, x, transpose=True)),
        (bdf_mod.block_diag_spmm_fused(blocks, x, w, transpose=True),
         bdf_mod.plain(blocks, x, w, transpose=True)),
        (bellf_mod.bell_spmm_fused(bell.blocks, bell.col_idx, bx, w,
                                   n_valid=bell.n_valid),
         bellf_mod.plain(bell.blocks, bell.col_idx, bx, w)),
        (bellf_mod.bell_spmm_dw(bell.blocks, bell.col_idx, bx, bx[:, :4],
                                n_valid=bell.n_valid),
         bellf_mod.plain_dw(bell.blocks, bell.col_idx, bx, bx[:, :4])),
    ]
    for got, want in cases:
        assert torch.equal(got, want)
    # the transposed read is the transpose of each block
    tp.assert_close(bd_mod.block_diag_spmm(blocks.transpose(1, 2)
                                           .contiguous(), x), cases[0][0])
    assert [c.value for c in counts] == before


@pytest.mark.parametrize("case", ["bd_shape", "bd_dtype", "bell_col_idx",
                                  "bell_y_in", "bdf_w", "bdf_y_in", "bellf_w",
                                  "bellf_dtype", "dw_identity_k", "dw_x",
                                  "dw_g"])
def test_wrappers_reject_bad_operands(case):
    blocks = torch.zeros((4, 8, 8))
    x = torch.zeros((32, 5))
    bblocks = torch.zeros((4, 3, 8, 8))
    col_idx = torch.zeros((4, 3), dtype=torch.int32)
    w = torch.zeros((5, 2))
    with pytest.raises(ValueError):
        if case == "bd_shape":
            bd_mod.block_diag_spmm(blocks, torch.zeros((30, 5)))
        elif case == "bd_dtype":
            bd_mod.block_diag_spmm(blocks.double(), x)
        elif case == "bell_col_idx":
            bell_mod.bell_spmm(bblocks, col_idx[:, :2], x)
        elif case == "bell_y_in":
            bell_mod.bell_spmm(bblocks, col_idx, x, torch.zeros((31, 5)))
        elif case == "bdf_w":
            bdf_mod.block_diag_spmm_fused(blocks, x, torch.zeros((4, 2)))
        elif case == "bdf_y_in":
            bdf_mod.block_diag_spmm_fused(blocks, x, w, torch.zeros((32, 5)))
        elif case == "bellf_w":
            bellf_mod.bell_spmm_fused(bblocks, col_idx, x, torch.zeros((6, 2)))
        elif case == "bellf_dtype":
            bellf_mod.bell_spmm_fused(bblocks, col_idx, x, w.double())
        elif case == "dw_identity_k":      # identity columns need K = 1
            bellf_mod.bell_spmm_dw(bblocks, None, x, torch.zeros((32, 2)))
        elif case == "dw_x":
            bellf_mod.bell_spmm_dw(bblocks, col_idx, torch.zeros((30, 5)),
                                   torch.zeros((32, 2)))
        else:
            bellf_mod.bell_spmm_dw(blocks.unsqueeze(1), None, x,
                                   torch.zeros((40, 2)))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("F", [1, 3, 16])
def test_block_diag_reads_an_expanded_bias_row_as_its_copy(F, transpose):
    """A y_in of one row repeated (strides (0, 1), as bias.expand gives)
    gives the bits of the same seed copied to (n, F)."""
    blocks, x, _ = map(torch.from_numpy, _block_diag_inputs(8, F, seed=F))
    bias = torch.from_numpy(np.random.default_rng(F + 1).standard_normal(
        F).astype(np.float32))
    row = bias.expand(x.shape[0], F)
    assert row.stride() == (0, 1) and bd_mod.y_in_ld(row) == 0
    assert bd_mod.y_in_ld(row.contiguous()) == F
    got = bd_mod.block_diag_spmm(blocks, x, row, transpose=transpose)
    assert torch.equal(got, bd_mod.block_diag_spmm(
        blocks, x, row.contiguous(), transpose=transpose))
    tp.assert_close(got, bd_mod.plain(blocks, x, transpose=transpose) + bias)


@pytest.mark.parametrize("layout", ["transposed", "column_slice",
                                    "row_step", "column_repeat"])
def test_block_diag_rejects_other_strided_y_in(layout):
    blocks, x, y_in = map(torch.from_numpy, _block_diag_inputs(8, 6, seed=9))
    n = x.shape[0]
    y_in = {"transposed": y_in.t().contiguous().t(),
            "column_slice": torch.zeros((n, 12))[:, ::2],
            "row_step": torch.zeros((2 * n, 6))[::2],
            "column_repeat": torch.zeros((n, 1)).expand(n, 6)}[layout]
    assert y_in.shape == x.shape and not y_in.is_contiguous()
    with pytest.raises(ValueError, match="strides"):
        bd_mod.block_diag_spmm(blocks, x, y_in)


def test_block_diag_acc_takes_the_bias_row_and_sums_its_gradient():
    """ops.block_diag_matvec_acc passes an expanded bias through uncopied;
    the bias gradient (autograd's expand summing dY) and dX equal the
    contiguous seed's."""
    from repro_torch.kernels import ops
    blocks, x, _ = map(torch.from_numpy, _block_diag_inputs(8, 5, seed=12))
    g = torch.from_numpy(np.random.default_rng(13).standard_normal(
        x.shape).astype(np.float32))
    seen = []
    real = ops.block_diag_spmm

    def spy(blocks_, x_, y_in=None, **kw):
        seen.append(None if y_in is None else y_in.stride())
        return real(blocks_, x_, y_in, **kw)

    grads = []
    for copy in (False, True):
        bias = torch.linspace(-1.0, 1.0, 5, requires_grad=True)
        xx = x.clone().requires_grad_(True)
        seed = bias.expand(x.shape[0], 5)
        ops.block_diag_spmm = spy
        try:
            y = ops.block_diag_matvec_acc(
                blocks, xx, seed.contiguous() if copy else seed)
        finally:
            ops.block_diag_spmm = real
        (y * g).sum().backward()
        grads.append((y.detach(), bias.grad, xx.grad))
    assert seen == [(0, 1), (5, 1)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    tp.assert_close(grads[0][1], g.sum(0))


def test_build_targets_hopper_and_names_libraries_by_content():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert name in _build.SIGNATURES
        # the ctypes argtypes match the C launch function's parameter list
        decl = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)
        assert decl is not None, name
        params = decl.group(1).split(",")
        assert len(_build.SIGNATURES[name]) == len(params), name
        for p, t in zip(params, _build.SIGNATURES[name]):
            assert (t is ctypes.c_void_p) == ("*" in p), (name, p)
    digests = {_build._digest(n) for n in _build.SOURCES}
    assert len(digests) == len(_build.SOURCES)


def test_every_included_header_is_in_the_build_digest():
    """Each ``#include "..."`` of a kernel source or header names a file in
    ``_build.HEADERS`` (so an edit to it changes every library's content
    digest and no stale library loads), and each listed header exists."""
    for h in _build.HEADERS:
        assert (_build.CSRC / h).is_file(), h
    files = sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))
    assert {f.stem for f in files if f.suffix == ".cu"} == set(_build.SOURCES)
    included = set()
    for f in files:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read_text(),
                               re.M):
            assert name in _build.HEADERS, (f.name, name)
            included.add(name)
    assert included == set(_build.HEADERS)
