"""Build, load and launch-check the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds.  All sources build in parallel,
one ``nvcc`` each, at the first launch of any kernel (never at import).
The libraries go into ``kernels/_build/`` (listed in ``.gitignore``),
named by a digest of the sources and flags, so a changed source never
loads a stale library.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("block_diag_spmm", "bell_spmm", "bell_spmm_fused", "bell_spmm_dw")
HEADERS = ("dtype.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of each library's launch function (pointers and the stream as
# c_void_p so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "block_diag_spmm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "bell_spmm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "bell_spmm_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P),
    "bell_spmm_dw": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _P),
}

# element types the kernels take, as the dtype code they are passed
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCK = 64


def check_operands(floats, ints=()) -> None:
    """Raise ValueError unless every operand lies on ``floats[0]``'s device
    and every float operand has its dtype.  ``None`` entries (absent
    optional operands) are skipped."""
    fs = [t for t in floats if t is not None]
    ts = fs + [t for t in ints if t is not None]
    x = floats[0]
    if any(t.device != x.device for t in ts):
        raise ValueError("operands must lie on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != x.dtype for t in fs):
        raise ValueError("float operands must share one dtype, got "
                         f"{[t.dtype for t in fs]}")


def cuda_dtype_code(floats, ints=(), block_size: int = 1) -> int:
    """The kernels' dtype code of ``floats[0]``, after checking that the
    operands can go to a CUDA kernel: on a CUDA device, float32 or
    bfloat16, int32 indices, all contiguous, and 1 <= block_size <= 64.
    ``None`` entries (absent optional operands) are skipped."""
    ts = [t for t in (*floats, *ints) if t is not None]
    x = floats[0]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"CUDA kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if any(t is not None and t.dtype != torch.int32 for t in ints):
        raise ValueError("index operands must be int32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("CUDA kernel takes contiguous tensors")
    if not 1 <= block_size <= MAX_BLOCK:
        raise ValueError(f"CUDA kernel takes block sizes 1..{MAX_BLOCK}, "
                         f"got {block_size}")
    return DTYPE_CODES[x.dtype]


def ptr(t: torch.Tensor | None) -> int | None:
    """Device address of an optional operand (None for an absent one)."""
    return t.data_ptr() if t is not None else None


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as ctypes takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


@dataclasses.dataclass(frozen=True)
class Built:
    """One loaded kernel library and what its build reported."""
    name: str
    seconds: float          # nvcc wall time; 0.0 when the library was reused
    ptxas: tuple            # ptxas register / spill lines of this build
    lib: ctypes.CDLL

    def launch(self, *args) -> None:
        """Call ``<name>_launch``; raises with CUDA's message on an error."""
        err = getattr(self.lib, f"{self.name}_launch")(*args)
        if err:
            msg = getattr(self.lib, f"{self.name}_error_string")(err)
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {err} "
                f"({msg.decode() if msg else 'unknown'})")


class LaunchCount:
    """Launches of one kernel: the wrapper adds one per kernel launch."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


_LOCK = threading.Lock()
_LIBS: dict[str, Built] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA toolkit torch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(install the CUDA toolkit or put nvcc on PATH)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def _load(name: str, path: Path, seconds: float, ptxas: tuple) -> Built:
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(SIGNATURES[name])
    fn.restype = ctypes.c_int
    es = getattr(lib, f"{name}_error_string")
    es.argtypes = [ctypes.c_int]
    es.restype = ctypes.c_char_p
    return Built(name, seconds, ptxas, lib)


def build_all() -> dict[str, Built]:
    """Build (in parallel) and load every kernel library not yet loaded."""
    with _LOCK:
        todo = [n for n in SOURCES if n not in _LIBS]
        if not todo:
            return dict(_LIBS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        try:
            for name in todo:
                so = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
                if so.exists():
                    _LIBS[name] = _load(name, so, 0.0, ())
                    continue
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), time.perf_counter(), tmp, so)
            for name, (proc, t0, tmp, so) in procs.items():
                out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for csrc/{name}.cu "
                        f"(exit {proc.returncode}):\n{out}{err}")
                os.replace(tmp, so)
                ptxas = tuple(
                    line.strip() for line in (out + err).splitlines()
                    if any(w in line for w in ("entry function", "Used",
                                               "spill")))
                _LIBS[name] = _load(name, so, seconds, ptxas)
        finally:
            for proc, _, tmp, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
        return dict(_LIBS)


def library(name: str) -> Built:
    """The loaded library of kernel ``name``, building all sources first
    if it is not loaded yet."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all()[name]
