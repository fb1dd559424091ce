"""The day-sharded sweeps and solves (counterpart of the day-sharded half
of `copula_var_tpu/parallel/quadrature.py`, :41-160 and :435-622).

Each function takes the full replicated inputs on every rank, as every
JAX process holds the full host copy, builds the bounds-invariant
operands for the full T (the transform's `t_ppf` rounds by its batch, so
a block built alone could move by an ulp), keeps this rank's block of
days (`DayMesh.day_block`), runs the port's own single-card code on it
(on a CUDA device the kernels: K2 for the sweeps, K1 for the bisection;
on the CPU their plain twins), and gathers the result over the mesh, so
every rank returns the full day axis. The bisection's global decisions
(halving count, all-zeros freeze, loop condition) are reduced over the
mesh (`ops/cuda_solver.py`); nothing else crosses ranks.

`VaRBacktest(mesh=...)` serves the same solves from operands it builds
once per backtest, at every dim. The grid-sharded half of the JAX module
(`grid_sharded_*`) is not ported yet (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from copula_var_tpu_torch.ops.cuda_quadrature import (
    masked_sweep,
    sweep_operands,
)
from copula_var_tpu_torch.ops.cuda_solver import (
    bisect_levels,
    full_solve_levels,
    full_solve_portfolios,
)
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    garch_day_tensors,
    msm_day_tensors,
)
from copula_var_tpu_torch.ops.refine import refine_roots
from copula_var_tpu_torch.parallel.mesh import DayMesh
from copula_var_tpu_torch.parallel.multiprocess import gather_days


def pad_days(arr, n_dev: int, axis: int = 0):
    """JAX's padding of the day axis up to a multiple of n_dev by
    repeating the final day. The port's mesh slices a short last block
    instead (`DayMesh.day_block`); this is kept for callers that need
    equal blocks."""
    T = arr.shape[axis]
    pad = (-T) % n_dev
    if pad == 0:
        return arr
    last = arr.narrow(axis, T - 1, 1)
    return torch.cat([arr] + [last] * pad, dim=axis)


def gather_solution(roots, nan_days, mesh: DayMesh, T: int):
    """(roots (L, T), nan_days (L, T)) on every rank from each rank's
    block: NaN days gather as flags (MAX), and their roots as 0, so the
    summed roots are exact."""
    roots = torch.where(nan_days, torch.zeros_like(roots), roots)
    return gather_days(roots, mesh, T), gather_days(nan_days, mesh, T)


def _t(mesh, a):
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           device=mesh.device)


def _f64(mesh, a):
    return _t(mesh, a).to(torch.float64)


def _block_operands(mesh, day_tensors, fcombos, densities, x, dx):
    """(SweepOperands of this rank's days, T): the MSM family with
    `densities` given, else the GARCH family."""
    V = _f64(mesh, day_tensors)
    days = mesh.days(V.shape[0])
    msm = densities is not None
    return sweep_operands(
        V[days].contiguous(), _f64(mesh, x), _f64(mesh, dx),
        _f64(mesh, densities) if msm else None,
        _f64(mesh, fcombos)[days].contiguous() if msm else None,
    ), V.shape[0]


def _block_sweep(mesh, ops, T, bounds, weights):
    """(T,) sweep of one bound set on every rank, this rank's block
    through `masked_sweep`."""
    b = _f64(mesh, bounds)[mesh.days(T)].contiguous()
    w = _f64(mesh, weights).reshape(1, -1)
    return gather_days(masked_sweep(ops, b[None], w)[0], mesh, T)


def sharded_msm_step(mesh: DayMesh, bounds, fbs, fcombos, x, dx, densities,
                     unique_vols, weights, spec: CopulaSpec):
    """Day-sharded MSM sweep (two assets) -> ((T,) integrals, their mean
    over all days from a summed partial, as the JAX `psum`)."""
    x, uv = _f64(mesh, x), _f64(mesh, unique_vols)
    tensors = msm_day_tensors(_f64(mesh, fbs), x, uv, spec)
    ops, T = _block_operands(mesh, tensors, fcombos, densities, x, dx)
    out = _block_sweep(mesh, ops, T, bounds, weights)
    local = out[mesh.days(T)].sum()
    return out, mesh.sum(local) / T


def sharded_garch_step(mesh: DayMesh, bounds, forecast_vols, x, dx, weights,
                       spec: CopulaSpec):
    """Day-sharded GARCH / mean-reverting sweep (two assets) -> (T,)."""
    x = _f64(mesh, x)
    tensors = garch_day_tensors(_f64(mesh, forecast_vols), x, spec)
    ops, T = _block_operands(mesh, tensors, None, None, x, dx)
    return _block_sweep(mesh, ops, T, bounds, weights)


def sharded_cached_step(mesh: DayMesh, bounds, day_tensors, fcombos, x, dx,
                        densities, weights):
    """Day-sharded sweep of cached day tensors (T, n, n) -> (T,);
    densities=None selects the GARCH family."""
    ops, T = _block_operands(mesh, day_tensors, fcombos, densities, x, dx)
    return _block_sweep(mesh, ops, T, bounds, weights)


def sharded_bisection_solve_levels(mesh: DayMesh, day_tensors, fcombos,
                                   densities, x, dx, weights, lower, upper,
                                   prev_result, prev_upper, upper_stack,
                                   obj_vars, tolerance, box_min=-5.0):
    """The multi-level bisection day-sharded over the mesh: state (L, T)
    each, obj_vars (L,), weights (2,) -> (L, T) roots on every rank. On
    a CUDA device each rank launches K1 on its block for the global
    halving count."""
    ops, T = _block_operands(mesh, day_tensors, fcombos, densities, x, dx)
    days = mesh.days(T)
    lo, up, pr, pu = (_f64(mesh, a)[:, days].contiguous()
                      for a in (lower, upper, prev_result, prev_upper))
    us = _t(mesh, upper_stack).to(torch.bool)[:, days].contiguous()
    obj = _f64(mesh, obj_vars).reshape(-1)
    w = _f64(mesh, weights).reshape(1, -1).expand(obj.shape[0], -1)
    roots = bisect_levels(ops, lo, up, pr, pu, us, obj, w.contiguous(),
                          float(tolerance), box_min, reducer=mesh)
    return gather_days(roots, mesh, T)


def sharded_bisection_solve(mesh: DayMesh, day_tensors, fcombos, densities,
                            x, dx, weights, lower, upper, prev_result,
                            prev_upper, upper_stack, obj_var, tolerance,
                            box_min=-5.0):
    """The one-level bisection: (T,) state -> (T,) roots on every rank
    (`sharded_bisection_solve_levels` at L = 1)."""
    return sharded_bisection_solve_levels(
        mesh, day_tensors, fcombos, densities, x, dx, weights,
        *(_t(mesh, a)[None] for a in (lower, upper, prev_result,
                                      prev_upper, upper_stack)),
        [obj_var], tolerance, box_min,
    )[0]


def _full(mesh, solve, day_tensors, fcombos, densities, x, dx, weights,
          obj_vars, cfg, tolerance, box_min, quirks, refine, h_rows):
    ops, T = _block_operands(mesh, day_tensors, fcombos, densities, x, dx)
    obj = _f64(mesh, obj_vars).reshape(-1)
    weights = _f64(mesh, weights)
    roots, nan_days = solve(ops, obj, weights, cfg, float(tolerance),
                            bool(quirks), box_min, reducer=mesh)
    if refine:
        rows = weights.reshape(-1, weights.shape[-1]).expand(
            obj.shape[0], -1)
        roots = refine_roots(ops, roots, obj, rows,
                             _f64(mesh, h_rows).expand(obj.shape[0]),
                             box_min)
    roots, nan_days = gather_solution(roots, nan_days, mesh, T)
    return roots.cpu().numpy(), nan_days.cpu().numpy()


def _cfg(first_guess, second_guess, min_var_value, max_var_value):
    return (float(first_guess), float(second_guess[0]),
            float(second_guess[1]), float(min_var_value),
            float(max_var_value))


def sharded_full_solve_levels(mesh: DayMesh, day_tensors, fcombos,
                              densities, x, dx, weights, obj_vars,
                              first_guess, second_guess, tolerance,
                              min_var_value, max_var_value, box_min=-5.0,
                              reference_quirks=False, refine=False,
                              refine_h=0.0):
    """The whole dim-2 solve (stage sweeps, bracket, bisection, and with
    `refine` the trap re-solve in +-refine_h) of L levels of one
    portfolio, day-sharded -> host (roots (L, T), nan_days (L, T)) on
    every rank."""
    return _full(mesh, full_solve_levels, day_tensors, fcombos, densities,
                 x, dx, weights, obj_vars,
                 _cfg(first_guess, second_guess, min_var_value,
                      max_var_value),
                 tolerance, box_min, reference_quirks, refine,
                 np.atleast_1d(refine_h))


def sharded_full_solve_portfolios(mesh: DayMesh, day_tensors, fcombos,
                                  densities, x, dx, weights_batch, obj_vars,
                                  first_guess, second_guess, tolerance,
                                  min_var_value, max_var_value, box_min=-5.0,
                                  reference_quirks=False, refine=False,
                                  refine_h=0.0):
    """`sharded_full_solve_levels` for L portfolio rows (weights_batch
    (L, 2), obj_vars (L,), refine_h scalar or (L,))."""
    return _full(mesh, full_solve_portfolios, day_tensors, fcombos,
                 densities, x, dx, weights_batch, obj_vars,
                 _cfg(first_guess, second_guess, min_var_value,
                      max_var_value),
                 tolerance, box_min, reference_quirks, refine,
                 np.atleast_1d(refine_h))
