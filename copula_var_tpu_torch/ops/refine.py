"""The `refine_root` pass on the solve (counterpart of the trap re-solve
that `copula_var_tpu/backtest.py` runs after its staircase bisection:
`_trap_refine_levels_jit`, `_trap_refine_portfolios_jit` and the in-program
refine of `_device_full_solve_{levels,portfolios}_jit`).

`ops/cuda_solver.py::full_solve` returns the staircase roots through the
kernels; `refine_roots` then re-solves each (row, day) in a
+-h window with 12 halvings of the trapezoid sweep (`ops/solvers.py::
trap_bisect`). The trap sweep reads the operands the backtest already
holds and builds nothing per query: the day tensors V of `SweepOperands`
at dim 2, the transform columns of `Contract3Operands` at dim 3 and of
`ColumnOperands` at dim >= 4. No TPU
kernel computes it (the JAX package runs it in XLA), so it is plain
PyTorch on the operands' device, rows one after another and days in
chunks of `ops/quadrature._device_day_batch`, which bounds its transient
memory.

Grid sharding: on operands of a range of outer grid rows the trap sweep
is those rows' share, and `refine_roots(grid=...)` sums it over the grid
ranks every halving (exact, in rank order), the counterpart of JAX's
`grid_sharded_{msm,garch,tcached}_trap_sweep`.
"""

from __future__ import annotations

import torch

from copula_var_tpu_torch.ops.cuda_quadrature3 import Contract3Operands
from copula_var_tpu_torch.ops.quadrature import (
    garch_integrals_trap,
    msm_integrals_trap,
    outer_slice,
)
from copula_var_tpu_torch.ops.solvers import trap_bisect
from copula_var_tpu_torch.ops.tcached import ColumnOperands, tcached_trap_sweep

TRAP_HALVINGS = 12


def trap_sweep(ops, bounds, weights, box_min=-5.0):
    """(L, T) trapezoid slab integrals for bounds (L, T, 2) and per-row
    portfolio weights (L, dim), from `SweepOperands` (dim 2),
    `Contract3Operands` (dim 3) or `ColumnOperands` (dim >= 4), on their
    device: the share of the operands' outer rows."""
    if isinstance(ops, (Contract3Operands, ColumnOperands)):
        return tcached_trap_sweep(ops, bounds, weights, box_min)
    outer = outer_slice(ops.rows)
    out = []
    for b, w in zip(bounds, weights):
        if ops.densities is None:
            out.append(garch_integrals_trap(b, ops.V, ops.x, w, box_min,
                                            rows=outer))
        else:
            out.append(msm_integrals_trap(b, ops.V, ops.forecast_combos,
                                          ops.x, ops.densities, w, box_min,
                                          rows=outer))
    return torch.stack(out)


def refine_roots(ops, roots, obj, weights, h, box_min=-5.0, grid=None):
    """Refined (L, T) roots from the staircase roots (L, T): row l
    re-solves for obj[l] with its own weights[l] (L, dim) in the window
    +-h[l] (L,). A rank's empty day block (`parallel/`) has nothing to
    refine. With a `grid` (`parallel.mesh.GridMesh`) the operands hold
    this rank's outer rows and every trap sweep is summed over the grid
    ranks."""
    if roots.shape[-1] == 0:
        return roots

    def sweep(b):
        F = trap_sweep(ops, b, weights, box_min)
        return F if grid is None else grid.grid_sum(F)
    return trap_bisect(sweep, roots, obj[:, None], h[:, None],
                       TRAP_HALVINGS)
