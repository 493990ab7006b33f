"""The port's kernel wrappers on the CPU: CPU tensors run the plain
version and launch nothing, bad operands raise, and the build targets
Hopper.  The plain versions' parity with the reference's Pallas kernels is
in tests/test_torch_jax_parity.py; the CUDA kernels are checked on the
card by tests/test_torch_cuda.py."""
import torch_parity as tp  # noqa: I001  (first: pins torch to one thread)

import numpy as np
import pytest
import torch

from repro_torch.core import formats as TF
from repro_torch.kernels import _build
from repro_torch.kernels import bell_spmm as bell_mod
from repro_torch.kernels import block_diag_spmm as bd_mod


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


@pytest.mark.parametrize("case", ["bd_shape", "bd_dtype", "bell_col_idx",
                                  "bell_y_in"])
def test_wrappers_reject_bad_operands(case):
    blocks = torch.zeros((4, 8, 8))
    x = torch.zeros((32, 5))
    bblocks = torch.zeros((4, 3, 8, 8))
    col_idx = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        if case == "bd_shape":
            bd_mod.block_diag_spmm(blocks, torch.zeros((30, 5)))
        elif case == "bd_dtype":
            bd_mod.block_diag_spmm(blocks.double(), x)
        elif case == "bell_col_idx":
            bell_mod.bell_spmm(bblocks, col_idx[:, :2], x)
        else:
            bell_mod.bell_spmm(bblocks, col_idx, x, torch.zeros((31, 5)))


def test_build_targets_hopper_and_names_libraries_by_content():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert name in _build.SIGNATURES
        assert len(_build.SIGNATURES[name]) == (9 if name == "block_diag_spmm"
                                                else 12)
    assert _build._digest("bell_spmm") != _build._digest("block_diag_spmm")
