"""Build and load the port's CUDA kernels.

The sources under `copula_var_tpu_torch/csrc/` are compiled at first use
by `nvcc` into a shared library with a plain C interface and loaded with
`ctypes` (no PyTorch headers, so a build takes seconds). The library
lands in `build/torch_kernels/<hash>/` at the repository root, keyed by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("quadrature.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "cvt_max_grid_points": [],
    "cvt_error_string": [_I],
    # v, wfc, w1, x, bounds, weights, box_min, out, T, n, q, L, stream
    "cvt_masked_sweep": [_P] * 6 + [_D, _P] + [_I] * 4 + [_P],
    # v, wfc, w1, x, lower, upper, prev_res, prev_up, ustack, obj,
    # weights, box_min, n_iters, roots, T, n, q, L, stream
    "cvt_bisect_levels": [_P] * 11 + [_D, _I, _P] + [_I] * 4 + [_P],
}

_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = ""  # nvcc's report (-Xptxas -v: registers, shared memory)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build from source at first "
        "use and need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "libcvt_kernels.so"


def build(force: bool = False) -> Path:
    """Compile the kernels unless a library for these exact sources
    exists (or `force`); returns its path."""
    global build_seconds, build_log
    out = library_path()
    if out.is_file() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}"
        )
    (out.parent / "build.log").write_text(build_log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a half file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cvt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        name = load().cvt_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({name})")
