"""ctypes bindings for the native host-side grid builder (counterpart of
`copula_var_tpu/native.py`; numpy only).

`native/grid_builder.cpp` implements the reference-exact ragged nested
grid (`utils/calc_integral/create_grids.py`, bivariate) and a masked
cached-tensor integral on the host. The library is the repository's
`native/libgrid_builder.so`; the first call that needs it loads it, and
runs `make -C native` first if it is missing. Importing this module loads
and builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgrid_builder.so")

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded library with its signatures declared (built first when
    the shared object is missing); a failure is not cached."""
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.nested_grid_rows_2d.restype = ctypes.c_int64
    lib.nested_grid_rows_2d.argtypes = [
        _D, ctypes.c_int64, ctypes.c_double, ctypes.c_double, _D,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.build_nested_grid_2d.restype = ctypes.c_int64
    lib.build_nested_grid_2d.argtypes = [
        _D, _D, ctypes.c_int64, _D, ctypes.c_int64, _I, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, _D, ctypes.c_double,
        ctypes.c_double, _D, _D,
    ]
    lib.masked_integrals_2d.restype = None
    lib.masked_integrals_2d.argtypes = [
        _D, _D, _D, ctypes.c_int64, _D, ctypes.c_int64, _D,
        ctypes.c_double, ctypes.c_double, _D,
    ]
    return lib


def available() -> bool:
    """Whether the library loads (building it if it is missing)."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def build_nested_grid(
    x, dx, densities, params, lower: float, upper: float, weights,
    box: Tuple[float, float] = (-5.0, 5.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-exact ragged grid + delta products (dim == 2).

    densities: (2, q, n); params: (L, 2) int state combos.
    Returns (grids (rows, 2), deltas (rows, L)).
    """
    lib = _load()
    x, dx, densities, weights = (_f64(a) for a in (x, dx, densities,
                                                    weights))
    params = np.ascontiguousarray(params, dtype=np.int64)
    if densities.ndim != 3 or densities.shape[0] != 2 or \
            densities.shape[2] != x.shape[0] or dx.shape != x.shape or \
            params.ndim != 2 or params.shape[1] != 2 or weights.shape != (2,):
        raise ValueError("build_nested_grid: expected x, dx (n,), densities "
                         "(2, q, n), params (L, 2) and weights (2,)")
    n, q, L = x.shape[0], densities.shape[1], params.shape[0]
    if params.size and (params.min() < 0 or params.max() >= q):
        raise ValueError(f"build_nested_grid: state indices outside [0, {q})")
    rows = lib.nested_grid_rows_2d(x, n, lower, upper, weights, box[0],
                                   box[1])
    grids = np.empty((rows, 2), dtype=np.float64)
    deltas = np.empty((rows, L), dtype=np.float64)
    written = lib.build_nested_grid_2d(
        x, dx, n, densities, q, params, L, lower, upper, weights,
        box[0], box[1], grids, deltas,
    )
    if written != rows:
        raise RuntimeError(f"build_nested_grid: wrote {written} rows of "
                           f"{rows}")
    return grids, deltas


def masked_integrals(
    day_tensors, x, dx, bounds, weights,
    box: Tuple[float, float] = (-5.0, 5.0),
) -> np.ndarray:
    """Native CPU masked integrals from (T, n, n) cached day tensors, the
    host analog of `ops.quadrature.garch_integrals_cached`."""
    lib = _load()
    V, x, dx, bounds, weights = (_f64(a) for a in (day_tensors, x, dx,
                                                    bounds, weights))
    T, n = V.shape[0], x.shape[0]
    if V.shape != (T, n, n) or dx.shape != (n,) or bounds.shape != (T, 2) \
            or weights.shape != (2,):
        raise ValueError("masked_integrals: expected day_tensors (T, n, n), "
                         "x, dx (n,), bounds (T, 2) and weights (2,)")
    out = np.empty(T, dtype=np.float64)
    lib.masked_integrals_2d(V, x, dx, n, bounds, T, weights, box[0], box[1],
                            out)
    return out
