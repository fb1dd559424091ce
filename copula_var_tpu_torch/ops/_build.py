"""Build and load the port's CUDA kernels.

Each source under `copula_var_tpu_torch/csrc/` is compiled at first use
by its own `nvcc` process (all started together) into a shared library
with a plain C interface, and loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). A library lands in
`build/torch_kernels/<hash>/` at the repository root, keyed by a hash of
its source, every header under `csrc/` and the flags, so an edited source
or header rebuilds and an unchanged one is reused (counted as
`build.compiled` and `build.loaded` in `utils.profiling.counters()`).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types
from pathlib import Path

from copula_var_tpu_torch.utils.profiling import count

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
# The kernels' limits, in one place: compiled into every source as -D
# defines, and read by the routes of ops/cuda_quadrature*.py. A block's
# opt-in shared memory on the H100 (227 KB), and the interval rule's two
# longest rows in chunks of 32 cells (csrc/interval.cuh): 192 (K1, the
# dim-3 table sweep, K2 up to 192) and 1024 (K2 past 192, the rebuild).
MAX_SHARED_BYTES = 232448
SHORT_CHUNKS = 6
MAX_CHUNKS = 32
# The dim-3 rebuild's bound rows per launch (csrc/contract3.cu): its
# per-row lookup state in shared memory, and so the widest (n, q) it takes.
WALK_ROWS = 32
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DCVT_MAX_SHARED_BYTES={MAX_SHARED_BYTES}",
    f"-DCVT_SHORT_CHUNKS={SHORT_CHUNKS}", f"-DCVT_MAX_CHUNKS={MAX_CHUNKS}",
    f"-DCVT_WALK_ROWS={WALK_ROWS}",
)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# source -> {C function: argtypes}. Each kernel's launcher has an f64 form
# and an f32 form (the same name + "_f32", the same arguments: tensors of
# the working type, scalars as doubles), but those of `_F64_ONLY`.
_KERNELS = {
    "quadrature.cu": {
        # v, wfc, w1, P, flags, T, n, rows, q, pitch, stream
        "cvt_sweep_table": [_P] * 5 + [_I] * 5 + [_P],
        # P, flags, x, bounds, weights, box_min, out, T, n, row0, rows, L,
        # pitch, stream
        "cvt_masked_sweep": [_P] * 5 + [_D, _P] + [_I] * 6 + [_P],
        # v, wfc, w1, x, lower, upper, prev_res, prev_up, ustack, obj,
        # weights, box_min, n_iters, roots, T, n, q, L, stream
        "cvt_bisect_levels": [_P] * 11 + [_D, _I, _P] + [_I] * 4 + [_P],
    },
    "contract3.cu": {
        # z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm,
        # logdet, U, flags, flagged, T, n, row0, rows, q, pitch, stride,
        # stream
        "cvt_contract3_weights": [_P] * 8 + [_I] + [_D] * 3 + [_P] * 3
        + [_I] * 7 + [_P],
        # U, flags, x, bounds, weights, box_min, out, T, n, row0, rows, L,
        # pitch, stride, stream
        "cvt_masked_contract3": [_P] * 5 + [_D, _P] + [_I] * 7 + [_P],
        # z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm,
        # logdet, flags, flagged, T, n, row0, rows, q, stream
        "cvt_contract3_row_flags": [_P] * 8 + [_I] + [_D] * 3 + [_P] * 2
        + [_I] * 5 + [_P],
        # z, fin, lu, p, w1, w2, g, sigma_inv, student, nu, log_norm,
        # logdet, flags, x, bounds, weights, box_min, partial, out, T, n,
        # row0, rows, q, L, stream
        "cvt_masked_contract3_rebuild": [_P] * 8 + [_I] + [_D] * 3
        + [_P] * 4 + [_D] + [_P] * 2 + [_I] * 6 + [_P],
    },
}
# launchers with an f64 form alone
_F64_ONLY = {
    "quadrature.cu": {
        # P, flags, x, obj, weights, first_guess, sg0, sg1, min_var,
        # max_var, quirks, box_min, lower, upper, prev_res, prev_up,
        # ustack, nan_days, widest, T, n, L, pitch, stream
        "cvt_solve_stages": [_P] * 5 + [_D] * 5 + [_I, _D] + [_P] * 7
        + [_I] * 4 + [_P],
        # v, wfc, w1, x, lower, upper, prev_res, prev_up, ustack, obj,
        # weights, box_min, widest, tolerance, roots, T, n, q, L, stream
        "cvt_bisect_levels_widest": [_P] * 11 + [_D, _P, _D, _P] + [_I] * 4
        + [_P],
    },
    "contract3.cu": {
        # U, flags, x, obj, weights, first_guess, sg0, sg1, min_var,
        # max_var, quirks, box_min, lower, upper, prev_res, prev_up,
        # ustack, nan_days, widest, T, n, L, pitch, stride, stream
        "cvt_solve_stages3": [_P] * 5 + [_D] * 5 + [_I, _D] + [_P] * 7
        + [_I] * 5 + [_P],
        # U, flags, x, lower, upper, prev_res, prev_up, ustack, obj,
        # weights, box_min, widest, tolerance, k_max, state, ustate, words,
        # roots, T, n, L, pitch, stride, stream
        "cvt_bisect3": [_P] * 10 + [_D, _P, _D, _I] + [_P] * 4 + [_I] * 5
        + [_P],
    },
}
SOURCES = {
    source: {**({"cvt_error_string": [_I]} if source == "quadrature.cu"
                else {}),
             **fns, **{f"{name}_f32": sig for name, sig in fns.items()},
             **_F64_ONLY.get(source, {})}
    for source, fns in _KERNELS.items()
}

_lib = None
build_seconds = None  # wall time of the builds this process ran, if any
build_log = ""  # nvcc's reports (-Xptxas -v: registers, shared memory)


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


def _digest(source: str) -> str:
    """Hash of the flags, the source and every header it may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_ROOT / _digest(source) / f"lib{Path(source).stem}.so"


def build(force: bool = False) -> list:
    """Compile every source whose library does not exist yet (or all,
    with `force`), one `nvcc` each, in parallel; returns the libraries'
    paths in `SOURCES` order."""
    global build_seconds, build_log
    outs = [library_path(s) for s in SOURCES]
    todo = [(s, o) for s, o in zip(SOURCES, outs) if force or not o.is_file()]
    count("build.loaded", len(outs) - len(todo))
    if not todo:
        return outs
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for source, out in todo:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs.append((cmd, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, out, tmp, proc in procs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        (out.parent / "build.log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees a half file
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    count("build.compiled", len(todo) - len(failed))
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load() -> types.SimpleNamespace:
    """The kernels' C functions, from libraries built if needed, with
    their signatures set."""
    global _lib
    if _lib is None:
        fns = {}
        for path, sigs in zip(build(), SOURCES.values()):
            lib = ctypes.CDLL(str(path))
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        fns["cvt_error_string"].restype = ctypes.c_char_p
        _lib = types.SimpleNamespace(**fns)
    return _lib


def function(name: str, dtype):
    """The launcher `name` for tensors of `dtype`: the f64 form for
    torch.float64, its `_f32` form for torch.float32; any other type
    raises."""
    import torch

    if dtype == torch.float64:
        return getattr(load(), name)
    if dtype == torch.float32:
        return getattr(load(), f"{name}_f32")
    raise ValueError(f"{name}: the kernels take float64 or float32 "
                     f"tensors, not {dtype}")


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        name = load().cvt_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({name})")
