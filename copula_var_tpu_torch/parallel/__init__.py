"""Day-sharded serving over several GPUs, one process per rank
(counterpart of `copula_var_tpu/parallel/`, its day-sharded half).

  distributed.py   initialize / shutdown / process_info / run_world
  mesh.py          DayMesh, make_mesh: one rank's block of days and the
                   all_reduce / broadcast it shares with the others
  multiprocess.py  shard_days, gather_days (the all_reduce gather)
  quadrature.py    the day-sharded sweeps and solves

`VaRBacktest(..., mesh=make_mesh())` serves every query of a backtest
this way at every dim; the grid-sharded engine waits for a later port
(ROADMAP.md queue 1, item 12).
"""

from copula_var_tpu_torch.parallel.mesh import DayMesh, make_mesh
from copula_var_tpu_torch.parallel.multiprocess import gather_days, shard_days
from copula_var_tpu_torch.parallel.quadrature import (
    pad_days,
    sharded_bisection_solve,
    sharded_bisection_solve_levels,
    sharded_cached_step,
    sharded_full_solve_levels,
    sharded_full_solve_portfolios,
    sharded_garch_step,
    sharded_msm_step,
)

__all__ = [
    "DayMesh",
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
]
