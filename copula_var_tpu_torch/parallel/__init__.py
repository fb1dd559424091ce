"""Sharded serving over several GPUs, one process per rank (counterpart
of `copula_var_tpu/parallel/`).

  distributed.py   initialize / shutdown / process_info / run_world
  mesh.py          DayMesh (one rank's block of days), GridMesh (one
                   rank's outer grid rows on a ('days', 'grid') mesh and
                   the exact grid_sum), make_mesh
  multiprocess.py  shard_days, gather_days (the all_reduce gather)
  quadrature.py    the day-sharded sweeps and solves (dim 2, and dim >= 3
                   as `sharded_tcached_*`), the post-hoc trap refine,
                   and the grid-sharded transforms, sweeps and trap
                   sweeps

`VaRBacktest(..., mesh=make_mesh())` serves every query of a backtest
day-sharded at every dim; `mesh=make_mesh(axis_names=("days", "grid"),
shape=(d, g))` grid-sharded (JAX's engine "grid_sharded").
"""

from copula_var_tpu_torch.parallel.mesh import DayMesh, GridMesh, make_mesh
from copula_var_tpu_torch.parallel.multiprocess import gather_days, shard_days
from copula_var_tpu_torch.parallel.quadrature import (
    grid_sharded_garch_integrals,
    grid_sharded_garch_sweep,
    grid_sharded_garch_transforms,
    grid_sharded_garch_trap_sweep,
    grid_sharded_msm_integrals,
    grid_sharded_msm_sweep,
    grid_sharded_msm_transforms,
    grid_sharded_msm_trap_sweep,
    grid_sharded_tcached_sweep,
    grid_sharded_tcached_trap_sweep,
    pad_days,
    sharded_bisection_solve,
    sharded_bisection_solve_levels,
    sharded_cached_step,
    sharded_full_solve_levels,
    sharded_full_solve_portfolios,
    sharded_garch_step,
    sharded_msm_step,
    sharded_tcached_bisection_solve_levels,
    sharded_tcached_full_solve_levels,
    sharded_tcached_integrals,
    sharded_tcached_trap_refine,
    trap_refine_gspmd_jit,
)

__all__ = [
    "DayMesh",
    "GridMesh",
    "make_mesh",
    "shard_days",
    "gather_days",
    "sharded_msm_step",
    "sharded_garch_step",
    "sharded_cached_step",
    "sharded_bisection_solve",
    "sharded_bisection_solve_levels",
    "sharded_full_solve_levels",
    "sharded_full_solve_portfolios",
    "pad_days",
    "sharded_tcached_integrals",
    "sharded_tcached_bisection_solve_levels",
    "sharded_tcached_full_solve_levels",
    "sharded_tcached_trap_refine",
    "trap_refine_gspmd_jit",
    "grid_sharded_garch_integrals",
    "grid_sharded_garch_transforms",
    "grid_sharded_garch_sweep",
    "grid_sharded_garch_trap_sweep",
    "grid_sharded_msm_integrals",
    "grid_sharded_msm_transforms",
    "grid_sharded_msm_sweep",
    "grid_sharded_msm_trap_sweep",
    "grid_sharded_tcached_sweep",
    "grid_sharded_tcached_trap_sweep",
]
