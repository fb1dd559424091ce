"""Solve-ready VaR backtest (counterpart of the serving half of
`copula_var_tpu/backtest.py`).

A `VaRBacktest` here is built from fitted state (`utils.artifacts.
load_artifacts`), not by fitting: it holds the integration inputs on the
caller's device, builds the bounds-invariant sweep operands once (two
assets: the (T, n, n) day tensors; three assets: the per-day transform
columns and `Contract3Operands`, with the table U on a CUDA device), and
answers VaR queries with the
three-stage solve (`ops/cuda_solver.py`):

  calc_var             one confidence level           -> (T,)
  calc_var_levels      L levels, one portfolio        -> (L, T)
  calc_var_portfolios  L (weights, level) rows        -> (L, T)
  calc_var_grid        P portfolios x L levels        -> (P, L, T)

On a CUDA device every sweep and the bisection run the hand-written
kernels (`masked_sweep` and `bisect_levels` at dim 2, `masked_contract3`
at dim 3); on the CPU they run the plain twins, the f64 oracle that
matches the JAX `xla` engine. Results come back as numpy float64, with
the portfolio mean added, as the JAX package returns them.

Weights pairing, kept from the reference: `weights[0]` pairs the inner
grid axis and `weights[1:]` the outer axes in order; only unequal
weights show it.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from copula_var_tpu_torch.data.returns import ReturnsData
from copula_var_tpu_torch.device import resolve_device
from copula_var_tpu_torch.ops.cuda_quadrature import sweep_operands
from copula_var_tpu_torch.ops.cuda_quadrature3 import contract3_operands
from copula_var_tpu_torch.ops.cuda_solver import (
    full_solve_levels,
    full_solve_portfolios,
    sweep_for,
)
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    garch_day_columns,
    garch_day_tensors,
    garch_integrals_cached,
    msm_day_columns,
    msm_day_tensors,
    msm_integrals_cached,
)

_FIT_LATER = "fitting is not ported yet (ROADMAP.md queue 1, items 6-8)"


class MsmIntegrationInputs(NamedTuple):
    x: torch.Tensor  # (n,)
    dx: torch.Tensor  # (n,)
    densities: torch.Tensor  # (dim, q, n)
    unique_vols: torch.Tensor  # (dim, q)
    forecasts_by_states: torch.Tensor  # (T, dim, q)
    forecast_combos: torch.Tensor  # (T, q^dim)


class GarchIntegrationInputs(NamedTuple):
    x: torch.Tensor  # (n,)
    dx: torch.Tensor  # (n,)
    forecast_vols: torch.Tensor  # (T, dim)


class MsmAdapter:
    """MSM family: mixture marginals over q vol states."""

    name = "msm"

    def fit(self, in_sample):
        raise NotImplementedError(f"MsmAdapter.fit: {_FIT_LATER}")

    def day_tensors(self, inputs: MsmIntegrationInputs, spec):
        return msm_day_tensors(inputs.forecasts_by_states, inputs.x,
                               inputs.unique_vols, spec)

    def integrals_cached(self, bounds, tensors, inputs, weights,
                         box_min=-5.0):
        return msm_integrals_cached(
            bounds, tensors, inputs.forecast_combos, inputs.x, inputs.dx,
            inputs.densities, weights, box_min,
        )

    def sweep_operands(self, tensors, inputs: MsmIntegrationInputs):
        return sweep_operands(tensors, inputs.x, inputs.dx, inputs.densities,
                              inputs.forecast_combos)

    def day_columns(self, inputs: MsmIntegrationInputs, spec):
        return msm_day_columns(inputs.forecasts_by_states, inputs.x,
                               inputs.unique_vols, spec)

    def contract3_operands(self, cols, inputs: MsmIntegrationInputs, spec):
        return contract3_operands(cols, inputs.x, inputs.dx, spec,
                                  densities=inputs.densities,
                                  forecast_combos=inputs.forecast_combos)


class GarchAdapter:
    """GARCH family: one forecast vol per asset and day (q = 1)."""

    name = "garch"

    def fit(self, in_sample):
        raise NotImplementedError(f"GarchAdapter.fit: {_FIT_LATER}")

    def day_tensors(self, inputs: GarchIntegrationInputs, spec):
        return garch_day_tensors(inputs.forecast_vols, inputs.x, spec)

    def integrals_cached(self, bounds, tensors, inputs, weights,
                         box_min=-5.0):
        return garch_integrals_cached(bounds, tensors, inputs.x, inputs.dx,
                                      weights, box_min)

    def sweep_operands(self, tensors, inputs: GarchIntegrationInputs):
        return sweep_operands(tensors, inputs.x, inputs.dx)

    def day_columns(self, inputs: GarchIntegrationInputs, spec):
        return garch_day_columns(inputs.forecast_vols, inputs.x, spec)

    def contract3_operands(self, cols, inputs: GarchIntegrationInputs, spec):
        tcols, p_cols = cols
        return contract3_operands(tcols, inputs.x, inputs.dx, spec,
                                  p_cols=p_cols)


_ADAPTERS = {"msm": MsmAdapter, "garch": GarchAdapter}


def _copula_spec(kind: str, fit_result, device) -> CopulaSpec:
    def corr():
        return torch.as_tensor(np.asarray(fit_result.corr_matrix),
                               dtype=torch.float64, device=device)

    if kind == "gaussian":
        return CopulaSpec("gaussian", (corr(),))
    if kind == "student":
        return CopulaSpec("student", (float(fit_result.nu), corr()))
    if kind == "plackett":
        return CopulaSpec("plackett", (float(fit_result.theta),))
    raise ValueError(f"unknown copula: {kind}")


class VaRBacktest:
    """Out-of-sample VaR backtest from fitted state.

    data: ReturnsData; adapter: MsmAdapter or GarchAdapter; copula: kind;
    copula_fit / model_fits: fitted records; integration_inputs: the
    adapter's inputs (tensors are moved to `device`, the card unless the
    caller asks for "cpu"); marginals / densities: the in-sample IFM
    inputs, kept for the record.
    """

    def __init__(self, data: ReturnsData, adapter, copula: str, copula_fit,
                 model_fits, integration_inputs, marginals=None,
                 densities=None, num_points=100, box=(-5.0, 5.0),
                 device="cuda", reference_quirks=False, refine_root=False):
        if data.dim not in (2, 3):
            raise ValueError(
                f"the port serves dim 2 and 3 (got dim={data.dim}); dim >= 4 "
                "is queued in ROADMAP.md (queue 1, item 10)"
            )
        if data.dim == 3 and copula == "plackett":
            raise ValueError(
                "the Plackett copula is bivariate; dim 3 takes Gaussian or "
                "Student (ROADMAP.md queue 1, item 10)"
            )
        if refine_root:
            raise ValueError(
                "refine_root is not ported yet (ROADMAP.md queue 1, item 10)"
            )
        self.device = resolve_device(device)
        self.data = data
        self.adapter = adapter
        self.copula = copula
        self.copula_fit = copula_fit
        self.model_fits = list(model_fits)
        self.num_points = num_points
        self.box = tuple(box)
        self.reference_quirks = bool(reference_quirks)
        self.refine_root = False
        self.marginals = marginals
        self.densities = densities
        self.copula_spec = _copula_spec(copula, copula_fit, self.device)
        self.integration_inputs = type(integration_inputs)(*[
            torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                            dtype=torch.float64, device=self.device)
            for v in integration_inputs
        ])
        self.weights = torch.as_tensor(data.weights, dtype=torch.float64,
                                       device=self.device)
        self._ops = None
        self.prep_seconds = 0.0

    # -- bounds-invariant state ------------------------------------------

    def sweep_operands(self):
        """The kernels' bounds-invariant operands, built once: day tensors
        and their hoisted contraction at dim 2, transform columns and
        `Contract3Operands` (with the table U on a CUDA device) at
        dim 3."""
        if self._ops is None:
            t0 = time.perf_counter()
            inputs, spec = self.integration_inputs, self.copula_spec
            if self.data.dim == 3:
                cols = self.adapter.day_columns(inputs, spec)
                self._ops = self.adapter.contract3_operands(cols, inputs,
                                                            spec)
            else:
                tensors = self.adapter.day_tensors(inputs, spec)
                self._ops = self.adapter.sweep_operands(tensors, inputs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prep_seconds = time.perf_counter() - t0
        return self._ops

    def _tensor(self, a):
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            dtype=torch.float64, device=self.device)

    def compute_integral(self, bounds) -> np.ndarray:
        """(T,) integrals over per-day [lower, upper] slabs (T, 2): one
        sweep, through the kernel on a CUDA device."""
        b = self._tensor(bounds).reshape(1, -1, 2).contiguous()
        ops = self.sweep_operands()
        out = sweep_for(ops)(ops, b, self.weights.reshape(1, -1),
                             self.box[0])
        return out[0].cpu().numpy()

    @staticmethod
    def adjust_integral(new_result, prev_results, bounds, prev_upper):
        """Incremental CDF bookkeeping: add the slab when its lower edge
        continues the previous upper bound, else subtract it."""
        add = bounds[:, 0] == prev_upper
        return torch.where(add, prev_results + new_result,
                           prev_results - new_result)

    # -- VaR solve --------------------------------------------------------

    def _cfg(self, first_guess, second_guess, min_var_value, max_var_value):
        return (float(first_guess), float(second_guess[0]),
                float(second_guess[1]), float(min_var_value),
                float(max_var_value))

    def calc_var_levels(self, obj_vars=(0.01, 0.025, 0.05), first_guess=-3.0,
                        second_guess=(-3.5, -2.0), tolerance=1e-6,
                        min_var_value=-7.5, max_var_value=0.0):
        """VaR at L confidence levels in one batched solve -> (L, T);
        row l equals `calc_var(obj_vars[l])`."""
        obj = self._tensor(np.atleast_1d(obj_vars))
        t0 = time.perf_counter()
        roots, nan_days = full_solve_levels(
            self.sweep_operands(), obj, self.weights,
            self._cfg(first_guess, second_guess, min_var_value,
                      max_var_value),
            tolerance, self.reference_quirks, self.box[0],
        )
        final = torch.where(nan_days, torch.full_like(roots, np.nan), roots)
        out = final.cpu().numpy() + self.data.ptf_mean
        self.solve_seconds = time.perf_counter() - t0
        return out

    def calc_var(self, obj_var=0.05, first_guess=-3.0,
                 second_guess=(-3.5, -2.0), tolerance=1e-6,
                 min_var_value=-7.5, max_var_value=0.0):
        """Three-stage VaR solve (`calc_var_class.py:95-177,250-309`):
        slab [-100, first_guess], one refinement slab, bisection to
        `tolerance`, plus the portfolio mean -> (T,)."""
        return self.calc_var_levels(
            [obj_var], first_guess, second_guess, tolerance, min_var_value,
            max_var_value,
        )[0]

    def calc_var_portfolios(self, weights_batch, obj_var=0.05,
                            first_guess=-3.0, second_guess=(-3.5, -2.0),
                            tolerance=1e-6, min_var_value=-7.5,
                            max_var_value=0.0):
        """VaR for L portfolios (weights_batch (L, dim)), each at its own
        level (obj_var scalar or (L,)), against the shared sweep operands ->
        (L, T), each row with its own portfolio mean."""
        weights_batch = np.atleast_2d(np.asarray(weights_batch, float))
        if weights_batch.shape[1] != self.data.dim:
            raise ValueError(f"weights_batch must be (L, {self.data.dim})")
        L = weights_batch.shape[0]
        obj = np.broadcast_to(np.atleast_1d(np.asarray(obj_var, float)), (L,))
        t0 = time.perf_counter()
        roots, nan_days = full_solve_portfolios(
            self.sweep_operands(), self._tensor(obj),
            self._tensor(weights_batch).contiguous(),
            self._cfg(first_guess, second_guess, min_var_value,
                      max_var_value),
            tolerance, self.reference_quirks, self.box[0],
        )
        final = torch.where(nan_days, torch.full_like(roots, np.nan), roots)
        ptf_means = np.asarray(self.data.in_sample_mean) @ weights_batch.T
        out = final.cpu().numpy() + ptf_means[:, None]
        self.solve_seconds = time.perf_counter() - t0
        return out

    def calc_var_grid(self, weights_batch, obj_vars, **kw):
        """VaR for the outer product of P portfolios x L levels in one
        batched solve -> (P, L, T); row (p, l) equals
        `calc_var(obj_vars[l])` of a backtest whose data carries
        weights_batch[p]."""
        weights_batch = np.atleast_2d(np.asarray(weights_batch, float))
        obj_vars = np.atleast_1d(np.asarray(obj_vars, dtype=np.float64))
        P, L = weights_batch.shape[0], obj_vars.shape[0]
        flat = self.calc_var_portfolios(np.repeat(weights_batch, L, axis=0),
                                        obj_var=np.tile(obj_vars, P), **kw)
        return flat.reshape(P, L, -1)
