"""The sharded sweeps and solves (counterpart of
`copula_var_tpu/parallel/quadrature.py`).

Day sharding (its :41-160 and :435-622):
Each function takes the full replicated inputs on every rank, as every
JAX process holds the full host copy, builds the bounds-invariant
operands for the full T (the transform's `t_ppf` rounds by its batch, so
a block built alone could move by an ulp), keeps this rank's block of
days (`DayMesh.day_block`), runs the port's own single-card code on it
and gathers the result over the mesh, so every rank returns the full day
axis. The sweep and the bisection of a rank's block (on a CUDA device
the kernels: K2 for the sweeps, K1 for the bisection; on the CPU their
plain twins) are its operands' route with the day mesh given
(`ops/cuda_solver.py::route`), which reduces the bisection's global
decisions (halving count, all-zeros freeze, loop condition) over the
mesh; nothing else crosses ranks.

Grid sharding (its :625-1106, `grid_sharded_*` with the JAX names): on
a `GridMesh` each rank holds n / g outer grid rows (grid axis 0, paired
with weights[1]) and every sweep is its rows' share, summed over the
grid ranks by `GridMesh.grid_sum` (exact and in rank order, where JAX
`psum`s), so every rank returns the same (T,) bits. The dim-2 sweeps run
`masked_sweep` on the rank's rows (K2 on a CUDA device); the trap twins
and the dim >= 3 transform-cached sweeps are plain PyTorch, as JAX's are
XLA. The transforms hold all the t_ppf work and are built once per
backtest.

The day-sharded dim >= 3 functions (`sharded_tcached_*`, JAX's names)
take the full transform columns on every rank where JAX takes them
placed and padded (`_tcached_place`), and build this rank's block of
operands as `VaRBacktest(mesh=)` does: `Contract3Operands` at dim 3 (K4
on a CUDA device, by the table or the rebuild), `ColumnOperands` above.
`day_batch` is taken for JAX's signature; the port's sweeps chunk days by
their own budget (`ops/quadrature._device_day_batch`).
`trap_refine_gspmd_jit` is JAX's post-hoc trap refine over dim-2 day
tensors: the port has no GSPMD, so it refines the roots of the tensors
it is given, on their device (a rank's block when called per rank).

The f32 engine day-sharded at dim 3 (JAX's engine "sharded_pallas", its
:1310-1437 and :1687-1763): `place_dim3_cache` builds this rank's block
of float32 `Contract3Operands` (K4's table U of the block alone on a
CUDA device) from the full transform columns, and returns them with the
shared part (the portfolio weights and T) where JAX returns its placed
(day leaves, shared leaves); `sharded_dim3_pallas_integrals`,
`sharded_dim3_pallas_bisection_solve_levels` and
`sharded_dim3_pallas_full_solve_levels` take that pair. They run the f32
K4 sweep (its plain twin on the CPU) under the bisection's reduced
global decisions, on float64 state (the f32 engine's dim-3 route); JAX's
`interpret` is taken and not used, as the device picks the kernel or
its twin. JAX's dim-2 f32 functions (`ops/pallas_solver.py::
*_pallas_levels_sharded`) carry no name here: `ops/cuda_solver.py::
full_solve(..., reducer=mesh)` on a rank's float32 block serves them,
and `VaRBacktest(engine="pallas", mesh=<DayMesh>)` serves the whole
engine.

`VaRBacktest(mesh=...)` serves the same solves from operands it builds
once per backtest, at every dim, for either mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from copula_var_tpu_torch.ops.cuda_quadrature import (
    F32,
    F64,
    SweepOperands,
    masked_sweep,
    sweep_operands,
)
from copula_var_tpu_torch.ops.cuda_quadrature3 import contract3_operands
from copula_var_tpu_torch.ops.cuda_solver import _routes, full_solve
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
from copula_var_tpu_torch.ops.tcached import column_operands
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


def _block_sweep(mesh, ops, T, bounds, weights, box_min=-5.0):
    """(T,) sweep of one bound set on every rank, this rank's block
    through the operands' sweep (`masked_sweep` at dim 2), in the
    operands' type."""
    dt = ops.x.dtype
    b = _f64(mesh, bounds)[mesh.days(T)].to(dt).contiguous()
    w = _f64(mesh, weights).reshape(1, -1).to(dt)
    sweep, _ = _routes(ops, False, mesh)
    return gather_days(sweep(ops, b[None], w, box_min)[0], mesh, T)


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
    halving count (K2 sweeps past K1's grid)."""
    ops, T = _block_operands(mesh, day_tensors, fcombos, densities, x, dx)
    return _block_bisection(mesh, ops, T, weights, lower, upper,
                            prev_result, prev_upper, upper_stack, obj_vars,
                            tolerance, box_min)


def _block_bisection(mesh, ops, T, weights, lower, upper, prev_result,
                     prev_upper, upper_stack, obj_vars, tolerance, box_min):
    """(L, T) roots on every rank: this rank's block of the (L, T) state
    bisected by the operands' route, its global decisions reduced over
    the mesh."""
    days = mesh.days(T)

    def block(a, dtype=torch.float64):  # (L, T) or (T,) -> (L, block)
        a = _t(mesh, a).to(dtype)
        return (a[None] if a.dim() == 1 else a)[:, days].contiguous()

    lo, up, pr, pu = (block(a) for a in (lower, upper, prev_result,
                                         prev_upper))
    us = block(upper_stack, torch.bool)
    obj = _f64(mesh, obj_vars).reshape(-1)
    w = _f64(mesh, weights).reshape(1, -1).expand(obj.shape[0], -1)
    _, bisect = _routes(ops, False, mesh)
    roots = bisect(ops, lo, up, pr, pu, us, obj, w.contiguous(),
                   float(tolerance), box_min)
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


def _full(mesh, ops, T, weights, obj_vars, cfg, tolerance, box_min, quirks,
          refine, h_rows):
    obj = _f64(mesh, obj_vars).reshape(-1)
    weights = _f64(mesh, weights)
    roots, nan_days = full_solve(ops, obj, weights, cfg, float(tolerance),
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
    ops, T = _block_operands(mesh, day_tensors, fcombos, densities, x, dx)
    return _full(mesh, ops, T, weights, obj_vars,
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
    ops, T = _block_operands(mesh, day_tensors, fcombos, densities, x, dx)
    return _full(mesh, ops, T, weights_batch, obj_vars,
                 _cfg(first_guess, second_guess, min_var_value,
                      max_var_value),
                 tolerance, box_min, reference_quirks, refine,
                 np.atleast_1d(refine_h))


def trap_refine_gspmd_jit(tensors, fcombos, densities, x, weights, roots,
                          obj, h, box_min=-5.0, is_msm=True,
                          portfolios=False):
    """Post-hoc trapezoid refinement of (L, T) staircase roots over dim-2
    day tensors (T, n, n) (JAX's second dispatch of refine_root on the
    fused engine): row l re-solves for obj[l] in +-h, with the shared
    weights (2,), or with `portfolios` its own weights[l] (L, 2) and h
    scalar or (L,). On the tensors' device; `is_msm` selects the MSM
    family (fcombos, densities) over the GARCH family."""
    V = (tensors.to(torch.float64) if torch.is_tensor(tensors)
         else _f64_any(tensors))
    dev = V.device

    def on(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a) if not torch.is_tensor(a) else a,
            dtype=torch.float64, device=dev)

    roots, obj = on(roots), on(obj).reshape(-1)
    L = roots.shape[0]
    weights = on(weights)
    rows = (weights if portfolios
            else weights.reshape(1, -1).expand(L, -1)).contiguous()
    # the trap sweep reads the day tensors, the grid and the state weights
    ops = SweepOperands(V, on(x), None, on(densities) if is_msm else None,
                        on(fcombos) if is_msm else None, None, None)
    return refine_roots(ops, roots, obj, rows,
                        on(h).reshape(-1).expand(L).contiguous(), box_min)


def _tcached_block_operands(mesh, cols, fcombos, densities, x, dx, spec,
                            family, table=True, dtype=F64):
    """(operands of this rank's block of days, T) from the full transform
    columns: the MSM family (`cols` the transform leaves, fcombos,
    densities) or the GARCH family (`cols` = (transform leaves, p_cols)).
    `Contract3Operands` of `dtype` at dim 3 (the K4 route on a CUDA
    device; G formed over all T, then cut) when `table`, else (and at
    dim >= 4) `ColumnOperands`."""
    msm = family == "msm"
    leaves, p_cols = (cols, None) if msm else cols
    leaves = tuple(_t(mesh, c) for c in leaves)
    T, dim = leaves[0].shape[0], leaves[0].shape[-2]
    days = mesh.days(T)
    kw = (dict(densities=_f64(mesh, densities),
               forecast_combos=_f64(mesh, fcombos))
          if msm else dict(p_cols=_f64(mesh, p_cols)))
    x, dx = _f64(mesh, x), None if dx is None else _f64(mesh, dx)
    if dim == 3 and table:
        return contract3_operands(leaves, x, dx, spec, dtype=dtype,
                                  days=days, **kw), T
    block = tuple(c[days].contiguous() for c in leaves)
    kw = {k: v if k == "densities" else v[days].contiguous()
          for k, v in kw.items()}
    return column_operands(block, x, dx, spec, **kw), T


def _check_T(T, given):
    if given is not None and int(given) != T:
        raise ValueError(f"T={given}, but the columns hold {T} days (the "
                         "port takes the unpadded columns)")


def sharded_tcached_integrals(mesh: DayMesh, bounds, cols, fcombos,
                              densities, x, dx, weights, spec: CopulaSpec,
                              family, day_batch=None, box_min=-5.0):
    """(T,) dim >= 3 integrals of the transform columns, day-sharded:
    this rank's block swept (K4 at dim 3 on a CUDA device), gathered on
    every rank. family "msm" or "garch"."""
    ops, T = _tcached_block_operands(mesh, cols, fcombos, densities, x, dx,
                                     spec, family)
    return _block_sweep(mesh, ops, T, bounds, weights, box_min)


def sharded_tcached_bisection_solve_levels(
        mesh: DayMesh, cols, fcombos, densities, x, dx, weights, lower,
        upper, prev_result, prev_upper, upper_stack, obj_vars, tolerance,
        spec: CopulaSpec, family, day_batch=None, box_min=-5.0):
    """The dim >= 3 multi-level bisection, day-sharded: state (L, T),
    obj_vars (L,), weights (dim,) -> (L, T) roots on every rank."""
    ops, T = _tcached_block_operands(mesh, cols, fcombos, densities, x, dx,
                                     spec, family)
    return _block_bisection(mesh, ops, T, weights, lower, upper,
                            prev_result, prev_upper, upper_stack, obj_vars,
                            tolerance, box_min)


def sharded_tcached_full_solve_levels(
        mesh: DayMesh, cols, fcombos, densities, x, dx, weights, obj_vars,
        first_guess, second_guess, tolerance, min_var_value, max_var_value,
        spec: CopulaSpec, family, day_batch=None, box_min=-5.0,
        reference_quirks=False, T=None, portfolios=False, refine=False,
        refine_h=0.0):
    """The whole dim >= 3 solve, day-sharded -> host (roots (L, T),
    nan_days (L, T)) on every rank; with `portfolios` weights is an
    (L, dim) batch, one row per level (taken for JAX's signature: the
    solve reads the weights' shape); with `refine` the trap re-solve in
    +-refine_h."""
    ops, T_cols = _tcached_block_operands(mesh, cols, fcombos, densities,
                                          x, dx, spec, family)
    _check_T(T_cols, T)
    return _full(mesh, ops, T_cols, weights, obj_vars,
                 _cfg(first_guess, second_guess, min_var_value,
                      max_var_value),
                 tolerance, box_min, reference_quirks, refine,
                 np.atleast_1d(refine_h))


def sharded_tcached_trap_refine(mesh: DayMesh, cols, fcombos, densities, x,
                                weights, roots, obj_vars, refine_h,
                                spec: CopulaSpec, family, day_batch=None,
                                box_min=-5.0, T=None, portfolios=False):
    """Refine (L, T) staircase roots against the day-sharded dim >= 3
    trap sweep -> host (L, T) on every rank; weights (dim,) shared, or
    with `portfolios` (L, dim), one row per level."""
    ops, T_cols = _tcached_block_operands(mesh, cols, fcombos, densities,
                                          x, None, spec, family,
                                          table=False)
    _check_T(T_cols, T)
    days = mesh.days(T_cols)
    r = _f64(mesh, roots)[:, days].contiguous()
    obj = _f64(mesh, obj_vars).reshape(-1)
    w = _f64(mesh, weights)
    rows = (w if portfolios else w.reshape(1, -1).expand(r.shape[0], -1))
    h = _f64(mesh, np.atleast_1d(refine_h)).expand(r.shape[0])
    out = refine_roots(ops, r, obj, rows.contiguous(), h.contiguous(),
                       box_min)
    return gather_days(out, mesh, T_cols).cpu().numpy()


# ---------------------------------------------------------------------------
# the f32 engine day-sharded at dim 3 (JAX's sharded_pallas: :1310-1437,
# :1687-1763)
# ---------------------------------------------------------------------------


def place_dim3_cache(mesh: DayMesh, cols, fcombos, densities, x, dx, weights,
                     spec: CopulaSpec, family):
    """The f32 engine's dim-3 operands of this rank's block of days (JAX's
    `place_dim3_cache` of a `build_{msm,garch}_dim3_cache`), from the full
    float64 transform columns as the `sharded_tcached_*` functions take
    them: float32 `Contract3Operands` of the block (K4's table U of the
    block alone on a CUDA device) and the shared part, (the portfolio
    weights (3,), T). Returns (ops, shared), JAX's (day_leaves_s,
    shared_leaves)."""
    ops, T = _tcached_block_operands(mesh, cols, fcombos, densities, x, dx,
                                     spec, family, dtype=F32)
    return ops, (_f64(mesh, weights).reshape(-1), T)


def _dim3_placed(ops, shared, family, kind):
    """(weights, T) of a `place_dim3_cache` pair, after checking that its
    operands are the f32 engine's of `family` and copula `kind`."""
    if ops.x.dtype != F32 or ops.spec.kind != kind or \
            (family == "msm") != (ops.densities is not None):
        raise ValueError(
            f"family={family!r}, kind={kind!r}: the operands are "
            f"{ops.x.dtype} of the {ops.spec.kind!r} copula and the "
            f"{'msm' if ops.densities is not None else 'garch'} family "
            "(place them with place_dim3_cache)")
    weights, T = shared
    return weights, int(T)


def sharded_dim3_pallas_integrals(mesh: DayMesh, bounds, ops, shared,
                                  family, kind, interpret=False,
                                  box_min=-5.0):
    """(T,) float32 dim-3 integrals over the slabs bounds (T, 2) with the
    placed weights, day-sharded: this rank's block through the f32 K4
    sweep (its plain twin on the CPU), gathered on every rank."""
    weights, T = _dim3_placed(ops, shared, family, kind)
    if _t(mesh, bounds).shape[0] != T:
        raise ValueError(f"bounds of {_t(mesh, bounds).shape[0]} days, the "
                         f"operands were placed for T={T}")
    return _block_sweep(mesh, ops, T, bounds, weights, box_min)


def sharded_dim3_pallas_bisection_solve_levels(
        mesh: DayMesh, ops, shared, lower, upper, prev_result, prev_upper,
        upper_stack, obj_vars, tolerance, family, kind, interpret=False,
        box_min=-5.0):
    """(L, T) float64 roots of the f32 engine's dim-3 bisection, day-
    sharded: state (L, T) each (float64), obj_vars (L,); this rank's
    block bisected on float64 state over the f32 K4 sweep, the halving
    count, the all-zeros freeze and the loop's exit taken over every
    rank's days; gathered on every rank."""
    weights, T = _dim3_placed(ops, shared, family, kind)
    return _block_bisection(mesh, ops, T, weights, lower, upper,
                            prev_result, prev_upper, upper_stack, obj_vars,
                            tolerance, box_min)


def sharded_dim3_pallas_full_solve_levels(
        mesh: DayMesh, ops, shared, obj_vars, first_guess, second_guess,
        tolerance, min_var_value, max_var_value, family, kind,
        interpret=False, box_min=-5.0, reference_quirks=False, T=None,
        weights_batch=None):
    """The whole f32 dim-3 solve (stage sweeps and bracket in float32,
    then the bisection), day-sharded -> host (roots (L, T), nan_days
    (L, T)) on every rank. weights_batch (L, 3): row l masks with its own
    weights (portfolio mode), else every row with the placed weights."""
    weights, T_ops = _dim3_placed(ops, shared, family, kind)
    _check_T(T_ops, T)
    w = weights if weights_batch is None else _f64(mesh, weights_batch)
    return _full(mesh, ops, T_ops, w, obj_vars,
                 _cfg(first_guess, second_guess, min_var_value,
                      max_var_value),
                 tolerance, box_min, reference_quirks, False, 0.0)


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
