"""copula_var_tpu_torch — the PyTorch + CUDA port of `copula_var_tpu`.

The JAX package beside it stays the reference; every module here mirrors
its counterpart's name and layout so each piece is easy to hold against
it. This slice covers the serving path: load fitted artifacts, build the
bounds-invariant day tensors, and solve the three-stage VaR (stage-1
sweep, stage-2 bracket, bisection) for one level, many levels, many
portfolios or their product grid.

  device.py      device resolution (a CUDA request without a GPU raises)
  data/          returns ingestion without pandas
  ops/           special functions, dim-2 cached quadrature, bracketing,
                 and the two hand-written CUDA kernels with their wrappers
  models/, copulas/   fitted-result records (fitting is later work)
  backtest.py    solve-ready VaRBacktest
  utils/         artifact loader

The caller picks the device; tensors on the CPU run the plain PyTorch
versions, tensors on a CUDA device run the kernels.
"""

from copula_var_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
