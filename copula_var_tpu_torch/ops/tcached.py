"""Bounds-invariant operands and the plain sweep of the dim >= 4 path
(counterpart of the JAX `xla` engine's transform-cached sweeps,
`copula_var_tpu/ops/quadrature.py::_msm_tcached` / `_garch_tcached`, which
`VaRBacktest._cached_integral_fn` serves at any dim >= 3).

No TPU kernel computes these: the JAX package runs them in XLA, and the
port in plain PyTorch on the operands' device, days in chunks of
`ops/quadrature._device_day_batch` (2^26 cells per chunk on a GPU, JAX's
16 MB budget on the CPU). Nothing here launches K1-K4.

A dim-4 density grid is T * n^4 float64 (262 GB at T = 500, n = 90), so
no table is built: `ColumnOperands` holds only the per-day transform
columns (T, dim, n) and the state weights, and every sweep rebuilds each
chunk's density, masks and contracts it. `tcached_sweep` is the
dim-general row sweep; on `Contract3Operands` (dim 3), which carry the
same fields, it is the K4 kernel's plain twin.

Grid sharding (`parallel/`): `ColumnOperands` built with `rows=(i0, i1)`
name a range of outer grid rows (the columns, T * dim * n values, stay
whole), and every sweep returns those rows' share, each day chunk's
density built on (i1 - i0, n, ..., n) only (the counterpart of JAX's
`grid_sharded_tcached_sweep`, XLA there too). The JAX grid engine's
per-device budget holds: a day's slab of rows * n^(dim - 1) cells may
not exceed MAX_GRID_ELEMENTS_PER_DAY.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    _day_batch,
    check_grid_slab,
    outer_slice,
    row_range,
    tcached_integrals,
)


class ColumnOperands(NamedTuple):
    """Bounds-invariant operands of every sweep of one dim >= 4 backtest:
    spec; cols, the transform columns (leaves (T, dim, n)); p_cols
    (T, dim, n) for the GARCH family, else None; x, dx (n,); densities
    (dim, q, n) and forecast_combos (T, q^dim) in ij order for the MSM
    family, else None; rows: (i0, i1), the outer grid rows swept, or None
    for all."""

    spec: CopulaSpec
    cols: tuple
    p_cols: Optional[torch.Tensor]
    x: torch.Tensor
    dx: torch.Tensor
    densities: Optional[torch.Tensor]
    forecast_combos: Optional[torch.Tensor]
    rows: Optional[Tuple[int, int]] = None

    @property
    def days(self) -> int:
        return self.cols[0].shape[0]


def column_operands(cols, x, dx, spec: CopulaSpec, densities=None,
                    forecast_combos=None, p_cols=None,
                    rows=None) -> ColumnOperands:
    """ColumnOperands for the MSM family (densities and forecast_combos
    given) or the GARCH family (p_cols given); with `rows` (i0, i1) those
    of outer grid rows [i0, i1). Raises, with the JAX package's message,
    when one day's grid (or with `rows` its slab) exceeds the per-day
    transient budget."""
    if spec.kind not in ("gaussian", "student"):
        raise ValueError(
            f"the dim >= 3 path takes the Gaussian or Student copula, not "
            f"{spec.kind!r} (the Plackett copula is bivariate)")
    T, dim, n = cols[0].shape
    if rows is None:
        _day_batch(n, dim, T)
    else:
        rows = row_range(rows, n)
        check_grid_slab(n, dim, rows[1] - rows[0])
    return ColumnOperands(spec, tuple(cols), p_cols, x, dx, densities,
                          forecast_combos, rows)


def tcached_sweep(ops, bounds, weights, box_min=-5.0):
    """(L, T) slab integrals, on the operands' device: row l is the
    transform-cached sweep at bounds[l] (T, 2) and weights[l] (dim,)
    (weights[0] pairs the inner grid axis); each day chunk's density is
    built once for all rows. `ops` is `ColumnOperands` or
    `Contract3Operands`."""
    return _rows(ops, bounds, weights, box_min, trap=False)


def tcached_trap_sweep(ops, bounds, weights, box_min=-5.0):
    """(L, T) trapezoid slab integrals (the `refine_root` twin of
    `tcached_sweep`), on the operands' device."""
    return _rows(ops, bounds, weights, box_min, trap=True)


def _rows(ops, bounds, weights, box_min, trap):
    return tcached_integrals(bounds, weights, ops.cols, ops.x, ops.dx,
                             ops.spec, box_min, p_cols=ops.p_cols,
                             densities=ops.densities,
                             forecast_combos=ops.forecast_combos, trap=trap,
                             rows=outer_slice(ops.rows))
