"""copula_var_tpu_torch — the PyTorch + CUDA port of `copula_var_tpu`.

The JAX package beside it stays the reference; every module here mirrors
its counterpart's name and layout so each piece is easy to hold against
it. The port goes from returns to a VaR series: fit MSM, GARCH or the UKF
mean-reverting model per asset and a Gaussian, Student-t or Plackett
copula by IFM (`backtest.create_var_backtest`, or `config.run_backtest`
from a `BacktestConfig`), or load saved fitted artifacts; build
the bounds-invariant sweep operands (dim 2: day tensors; dim 3 and
above: transform columns); and solve the three-stage VaR (stage-1 sweep,
stage-2 bracket, bisection) for one level, many levels, many portfolios
or their product grid.

  device.py      device resolution: the card by default; a CUDA request
                 without a GPU raises
  config.py      the run's dataclasses and run_backtest
  data/          returns ingestion without pandas, synthetic_dataset
  ops/           special functions, grids, cached and transform-cached
                 quadrature, bracketing, golden-section and batched
                 L-BFGS solvers, and the hand-written CUDA kernels
                 (csrc/) with their wrappers
  models/        GARCH, MSM and UKF filters, their simulators and fits
  copulas/       Gaussian, Student-t and Plackett IFM likelihoods and fits
  backtest.py    create_var_backtest, the adapters, VaRBacktest
  parallel/      day- and grid-sharded serving over several GPUs, one
                 process per rank (torch.distributed): DayMesh, GridMesh,
                 the all_reduce gather and the exact grid_sum
  utils/         artifact save and load, StageTimer, trace_to, the
                 port's spans (span) and counters (count, counters)
  native.py      ctypes bindings of native/libgrid_builder.so (numpy only)
  plots.py       diagnostic figures (matplotlib, imported at first use)

The entry points run on the card unless the caller asks for "cpu";
tensors on the CPU run the plain PyTorch versions, tensors on a CUDA
device run the kernels (dim 2 and 3; four or more assets run the plain
transform-cached sweep on every device, as the JAX package's XLA does).
"""

from copula_var_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
