"""The sharded sweeps and solves (counterpart of
`copula_var_tpu/parallel/quadrature.py`).

Day sharding (its :41-160 and :435-622):
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

Grid sharding (its :625-1106, `grid_sharded_*` with the JAX names): on
a `GridMesh` each rank holds n / g outer grid rows (grid axis 0, paired
with weights[1]) and every sweep is its rows' share, summed over the
grid ranks by `GridMesh.grid_sum` (exact and in rank order, where JAX
`psum`s), so every rank returns the same (T,) bits. The dim-2 sweeps run
`masked_sweep` on the rank's rows (K2 on a CUDA device); the trap twins
and the dim >= 3 transform-cached sweeps are plain PyTorch, as JAX's are
XLA. The transforms hold all the t_ppf work and are built once per
backtest.

`VaRBacktest(mesh=...)` serves the same solves from operands it builds
once per backtest, at every dim, for either mesh.
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
    _inside,
    _pdf_product,
    copula_density_cols,
    garch_day_tensors,
    garch_integrals_trap,
    halfspace_frac,
    msm_day_tensors,
    tcached_integrals,
    transform_u_columns,
    trap_weights,
)
from copula_var_tpu_torch.ops.refine import refine_roots
from copula_var_tpu_torch.ops.special import norm_cdf, norm_pdf
from copula_var_tpu_torch.parallel.mesh import DayMesh, GridMesh
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


# ---------------------------------------------------------------------------
# grid sharding (counterpart of the grid half, :625-1106)
# ---------------------------------------------------------------------------


def _f64_any(a):
    """A float64 tensor of `a` (a tensor keeps its device)."""
    if torch.is_tensor(a):
        return a.to(torch.float64)
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _stacked(mesh, *cols):
    """Per-dim transform columns (tuples of (T, n) leaves) -> the
    (T, dim, n) leaves `copula_density_cols` reads."""
    return tuple(torch.stack([_t(mesh, a) for a in leaf], dim=-2)
                 for leaf in zip(*cols))


def _garch_rows(mesh, t0, p0, t1, p1, spec, cut):
    """The GARCH-family density nan_to_num(C * pdf-product) of every day
    on the outer rows `cut`: (T, rows, n)."""
    pdf = _pdf_product(torch.stack((_f64(mesh, p0), _f64(mesh, p1)), -2),
                       cut)
    return torch.nan_to_num(copula_density_cols(_stacked(mesh, t0, t1), spec,
                                                cut) * pdf)


def _check_axes(grid_axis, day_axis=None):
    """The port's grid mesh names its axes 'grid' and 'days' (JAX's
    defaults); any other name is refused, not ignored."""
    if grid_axis != "grid" or day_axis not in (None, "days"):
        raise ValueError(f"grid_axis={grid_axis!r}, day_axis={day_axis!r}: "
                         "a GridMesh's axes are 'grid' and 'days'")


def _day_cut(mesh, day_axis, T):
    """The days this rank serves: its block of the mesh's day axis when
    `day_axis` names it (T must divide, as in JAX), else all."""
    if day_axis is None:
        return slice(None)
    d = mesh.day_mesh.size
    if T % d:
        raise ValueError(f"T {T} not divisible by {d}")
    return mesh.day_mesh.days(T)


def grid_sharded_garch_transforms(forecast_vols, x, spec: CopulaSpec):
    """Bounds-invariant prep of the grid-sharded GARCH / mean-reverting
    sweep: each asset's copula pre-transform columns and pdf columns,
    (t0, p0, t1, p1), t0 and t1 tuples of (T, n) leaves (all the t_ppf
    work, once per backtest)."""
    x, fv = _f64_any(x), _f64_any(forecast_vols)
    u = [norm_cdf(x[None, :] / fv[:, d:d + 1]) for d in (0, 1)]
    p = [norm_pdf(x[None, :] / fv[:, d:d + 1]) / fv[:, d:d + 1]
         for d in (0, 1)]
    return (transform_u_columns(u[0], spec), p[0],
            transform_u_columns(u[1], spec), p[1])


def grid_sharded_msm_transforms(fbs, x, dx, densities, unique_vols,
                                spec: CopulaSpec):
    """Bounds-invariant prep of the grid-sharded MSM sweep: each asset's
    mixture-CDF copula pre-transform columns and the rotated state-weight
    rows, (t0, t1, w0 = densities[1] dx (outer axis), w1 = densities[0]
    dx (inner axis))."""
    x, dx, fbs = _f64_any(x), _f64_any(dx), _f64_any(fbs)
    dens, uv = _f64_any(densities), _f64_any(unique_vols)
    u = [torch.sum(fbs[:, d, :, None]
                   * norm_cdf(x[None, None, :] / uv[d][:, None]), dim=1)
         for d in (0, 1)]
    return (transform_u_columns(u[0], spec), transform_u_columns(u[1], spec),
            dens[1] * dx[None, :], dens[0] * dx[None, :])


def grid_sharded_garch_sweep(mesh: GridMesh, bounds, t0, p0, t1, p1, x, dx,
                             weights, spec: CopulaSpec, grid_axis="grid",
                             box_min=-5.0):
    """(T,) GARCH / mean-reverting integrals from prebuilt transforms on
    every rank: this rank's outer grid rows (its n / g of x, paired with
    weights[1]) through `masked_sweep` (K2 on a CUDA device, the plain
    twin on the CPU), summed over the grid ranks."""
    _check_axes(grid_axis)
    x = _f64(mesh, x)
    rows = mesh.rows(x.shape[0])
    V = _garch_rows(mesh, t0, p0, t1, p1, spec, slice(*rows))
    ops = sweep_operands(V, x, _f64(mesh, dx), rows=rows)
    part = masked_sweep(ops, _f64(mesh, bounds)[None].contiguous(),
                        _f64(mesh, weights).reshape(1, -1), box_min)[0]
    return mesh.grid_sum(part)


def grid_sharded_msm_sweep(mesh: GridMesh, bounds, t0, t1, w0, w1, fcombos,
                           x, weights, spec: CopulaSpec, grid_axis="grid",
                           day_axis=None, box_min=-5.0):
    """(T,) MSM integrals from prebuilt transforms on every rank: this
    rank's outer grid rows through `masked_sweep`, summed over the grid
    ranks; with `day_axis` ("days") its block of days too, gathered over
    the mesh's day axis. The (q, n) rows w0, w1 enter the operands as
    densities with unit steps (w * 1.0 is exact)."""
    _check_axes(grid_axis, day_axis)
    x = _f64(mesh, x)
    rows = mesh.rows(x.shape[0])
    b = _f64(mesh, bounds)
    T = b.shape[0]
    days = _day_cut(mesh, day_axis, T)
    cols = tuple(c[days] for c in _stacked(mesh, t0, t1))
    C = copula_density_cols(cols, spec, slice(*rows))
    ops = sweep_operands(
        C, x, torch.ones_like(x),
        densities=torch.stack((_f64(mesh, w1), _f64(mesh, w0))),
        forecast_combos=_f64(mesh, fcombos)[days].contiguous(), rows=rows)
    part = masked_sweep(ops, b[days][None].contiguous(),
                        _f64(mesh, weights).reshape(1, -1), box_min)[0]
    out = mesh.grid_sum(part)
    return out if day_axis is None else gather_days(out, mesh.day_mesh, T)


def grid_sharded_garch_integrals(mesh: GridMesh, bounds, forecast_vols, x,
                                 dx, weights, spec: CopulaSpec,
                                 axis: str = "grid"):
    """One integral per day with the OUTER grid axis sharded: each rank
    holds n / g outer points, sweeps its share and the shares are summed
    over the grid ranks (JAX's `psum`). dim 2; raises unless g divides
    n."""
    mesh.rows(np.asarray(x).shape[0])
    t0, p0, t1, p1 = grid_sharded_garch_transforms(forecast_vols, x, spec)
    return grid_sharded_garch_sweep(mesh, bounds, t0, p0, t1, p1, x, dx,
                                    weights, spec, grid_axis=axis)


def grid_sharded_msm_integrals(mesh: GridMesh, bounds, fbs, fcombos, x, dx,
                               densities, unique_vols, weights,
                               spec: CopulaSpec, grid_axis: str = "grid",
                               day_axis=None):
    """MSM-family integrals with the OUTER grid axis sharded (and with
    `day_axis` the days over the mesh's day axis, T divisible by it).
    dim 2; raises unless g divides n."""
    mesh.rows(np.asarray(x).shape[0])
    t0, t1, w0, w1 = grid_sharded_msm_transforms(fbs, x, dx, densities,
                                                 unique_vols, spec)
    return grid_sharded_msm_sweep(mesh, bounds, t0, t1, w0, w1, fcombos, x,
                                  weights, spec, grid_axis=grid_axis,
                                  day_axis=day_axis)


def _trap_scale(x):
    """(tw, tw / dx): trapezoid node weights, and the factor that turns
    dx-scaled state rows into trapezoid-weighted ones (JAX's
    `_trap_scale`, dx the grid's steps with dx[0] = dx[1])."""
    dx = torch.diff(x, prepend=x[:1])
    dx[0] = dx[1]
    tw = trap_weights(x)
    return tw, tw / dx


def grid_sharded_msm_trap_sweep(mesh: GridMesh, bounds, t0, t1, w0, w1,
                                fcombos, x, weights, spec: CopulaSpec,
                                grid_axis="grid", day_axis=None,
                                box_min=-5.0):
    """Trapezoid twin of `grid_sharded_msm_sweep` (refine_root): the
    dx-scaled state rows rescaled by tw / dx, the inner cell cut
    fractionally, this rank's rows summed over the grid ranks. Plain
    PyTorch on the mesh's device."""
    _check_axes(grid_axis, day_axis)
    x = _f64(mesh, x)
    cut = slice(*mesh.rows(x.shape[0]))
    b = _f64(mesh, bounds)
    T = b.shape[0]
    days = _day_cut(mesh, day_axis, T)
    tw, scale = _trap_scale(x)
    w0t, w1t = _f64(mesh, w0) * scale, _f64(mesh, w1) * scale
    C = copula_density_cols(tuple(c[days] for c in _stacked(mesh, t0, t1)),
                            spec, cut)
    A = halfspace_frac(x, tw, b[days, 0], b[days, 1], _f64(mesh, weights),
                       box_min, x[cut])
    S = (w0t[:, cut] @ _inside(C, A) @ w1t.T).reshape(C.shape[0], -1)
    part = torch.sum(S * _f64(mesh, fcombos)[days], dim=-1)
    out = mesh.grid_sum(part)
    return out if day_axis is None else gather_days(out, mesh.day_mesh, T)


def grid_sharded_garch_trap_sweep(mesh: GridMesh, bounds, t0, p0, t1, p1, x,
                                  weights, spec: CopulaSpec,
                                  grid_axis="grid", box_min=-5.0):
    """Trapezoid twin of `grid_sharded_garch_sweep` (refine_root): this
    rank's rows of tw^T (V .* A) tw summed over the grid ranks. Plain
    PyTorch on the mesh's device."""
    _check_axes(grid_axis)
    x = _f64(mesh, x)
    cut = slice(*mesh.rows(x.shape[0]))
    V = _garch_rows(mesh, t0, p0, t1, p1, spec, cut)
    return mesh.grid_sum(garch_integrals_trap(
        _f64(mesh, bounds), V, x, _f64(mesh, weights), box_min, rows=cut))


def _tcached_rows(mesh, bounds, cols0, cols_rest, p0, p_rest, fcombos, x,
                  dx, densities, weights, kind, params, family, day_batch,
                  box_min, trap, grid_axis):
    _check_axes(grid_axis)
    x = _f64(mesh, x)
    cols = tuple(torch.cat([_t(mesh, c0)[:, None], _t(mesh, cr)], dim=1)
                 for c0, cr in zip(cols0, cols_rest))
    msm = family == "msm"
    p_cols = None if msm else torch.cat(
        [_f64(mesh, p0)[:, None], _f64(mesh, p_rest)], dim=1)
    part = tcached_integrals(
        _f64(mesh, bounds)[None], _f64(mesh, weights)[None], cols, x,
        None if dx is None else _f64(mesh, dx), CopulaSpec(kind, params),
        box_min, day_batch, p_cols=p_cols,
        densities=_f64(mesh, densities) if msm else None,
        forecast_combos=_f64(mesh, fcombos) if msm else None, trap=trap,
        rows=slice(*mesh.rows(x.shape[0])))[0]
    return mesh.grid_sum(part)


def grid_sharded_tcached_sweep(mesh: GridMesh, bounds, cols0, cols_rest, p0,
                               p_rest, fcombos, x, dx, densities, weights,
                               kind, params, family, day_batch, box_min=-5.0,
                               grid_axis="grid"):
    """(T,) integrals at dim >= 3 with the OUTERMOST grid axis sharded:
    this rank's (n / g, n, ..., n) slab of every day's density rebuilt
    from the transform columns (cols0 / p0 the dim-0 leaves (T, n),
    cols_rest / p_rest dims 1.. (T, dim - 1, n)), masked and contracted,
    and the (T,) shares summed over the grid ranks. Plain PyTorch on the
    mesh's device, as JAX's is XLA; `VaRBacktest` serves dim 3 through
    K4 instead."""
    return _tcached_rows(mesh, bounds, cols0, cols_rest, p0, p_rest,
                         fcombos, x, dx, densities, weights, kind, params,
                         family, day_batch, box_min, False, grid_axis)


def grid_sharded_tcached_trap_sweep(mesh: GridMesh, bounds, cols0, cols_rest,
                                    p0, p_rest, fcombos, x, densities,
                                    weights, kind, params, family, day_batch,
                                    box_min=-5.0, grid_axis="grid"):
    """Trapezoid twin of `grid_sharded_tcached_sweep` (refine_root)."""
    return _tcached_rows(mesh, bounds, cols0, cols_rest, p0, p_rest,
                         fcombos, x, None, densities, weights, kind, params,
                         family, day_batch, box_min, True, grid_axis)
