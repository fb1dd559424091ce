"""VaR backtest: the fit-to-VaR orchestrator and the solve-ready
`VaRBacktest` (counterpart of `copula_var_tpu/backtest.py`).

`create_var_backtest` goes from returns to a solve-ready backtest on the
caller's device, as the JAX factory does: model fit per asset
(`MsmAdapter.fit`, `GarchAdapter.fit`, `MeanRevertingAdapter.fit`),
in-sample marginals and
densities, the IFM copula fit, the per-day integration inputs of every
out-of-sample window, then `VaRBacktest`. `utils.artifacts.
load_artifacts` builds the same object from saved fitted state instead.

A `VaRBacktest` holds the integration inputs on its device, builds the
bounds-invariant sweep operands once (two assets: the (T, n, n) day
tensors; three assets: the per-day transform columns and
`Contract3Operands`, with the table U on a CUDA device; four or more: the
transform columns as `ColumnOperands`, no table), and answers VaR
queries with the three-stage solve (`ops/cuda_solver.py::full_solve`),
whose route (stages, sweep and bisection) follows from those operands
and the mesh in `ops/cuda_solver.py::route`; this module chooses none:

  calc_var             one confidence level           -> (T,)
  calc_var_levels      L levels, one portfolio        -> (L, T)
  calc_var_portfolios  L (weights, level) rows        -> (L, T)
  calc_var_grid        P portfolios x L levels        -> (P, L, T)

With `refine_root=True` each query's staircase roots are re-solved in a
+-h window against the trapezoid sweep (`ops/refine.py`, plain PyTorch on
the same operands), h = max(dx) |w0| per portfolio row.

Engines (`engine`, JAX's `VaRBacktest.engine`): "xla", the default, is
the f64 path below; "pallas" is the f32 engine of JAX's "Production
serving" recipe: the f64 prep cast to float32 (`sweep_operands`), which
`full_solve` serves through the f32 kernels (K1 for a fixed count of
halvings, K2, K4) or their f32 plain twins on the CPU, roots within
`ops/solvers.root_plateau_bound(dx, weights)` (one grid cell x |w0|) of
the f64 engine's, not its bits; `refine_root` re-solves them against the
float64 trapezoid sweep. It serves dim 2 and 3 with the MSM or GARCH
integrand, on one device or on a day mesh (below); dim >= 4, a plugin
adapter or a grid mesh raise. Assigning `engine` drops the built
operands, so `bt.engine = "pallas"` after `load_artifacts` serves the f32
engine.

On a CUDA device every sweep and the bisection run the hand-written
kernels (`solve_stages` and `bisect_levels`, or `masked_sweep`, at dim
2; `solve_stages3` and `bisect3`, or `masked_contract3`, at dim 3); on
the CPU they run the plain twins,
the f64 oracle that matches the JAX `xla` engine. At dim >= 4 the JAX
package has no Pallas kernel, and every device runs the plain
transform-cached sweep (`ops/tcached.py`), as its `xla` engine does; the
grid is capped at 2^26 cells per day (num_points <= 90 at dim 4).
Fitting is plain PyTorch on the same device. Results come back as numpy
float64, with the portfolio mean added, as the JAX package returns them.

Weights pairing, kept from the reference: `weights[0]` pairs the inner
grid axis and `weights[1:]` the outer axes in order; only unequal
weights show it.

Day sharding (the JAX engine "sharded", `backtest.py:1164-1340,
2204-2258`): with `mesh=` a `parallel.mesh.DayMesh`, one process per
rank, every rank holds the full replicated state and builds the full-T
day tensors or transform columns (`t_ppf` rounds by its batch, so a
block built alone could move by an ulp), then keeps its own block of
days and builds P (K2), U (K4) or `ColumnOperands` for that block only.
Every query runs the single-card solve on the block, with the
bisection's global decisions reduced over the mesh
(`ops/cuda_solver.py`), and gathers the (L, T) series, so every rank
returns the full result, bit-equal to one card's. `create_var_backtest`
with a mesh fits on every rank and then takes rank 0's fitted state, so
the ranks serve one state even where a card's fit does not reproduce
its bits.

The f32 engine on a day mesh is the JAX engine "sharded_pallas"
(`backtest.py:1164-1340, 2100-2258`): each rank casts its block of the
full-T day tensors or columns to float32 (every batched product formed
over all T, then cut) and runs the f32 kernels on it, K1 for a fixed
count with no collective at dim 2, K4 under the bisection's reduced
global decisions at dim 3, so every rank returns the one-card f32
engine's bits. Its `compute_integral` is, as JAX's, the float64
day-sharded sweep at dim 2 (f64 K2 on the block's f64 day tensors and
prefix table, built on the first such call, never by a solve) and the
f32 K4 sweep at dim 3; `refine_root` re-solves the block's roots against
the block's float64 trap operands.

Grid sharding (the JAX engine "grid_sharded", `backtest.py:1342-1486`):
with `mesh=` a `parallel.mesh.GridMesh` of shape (d, g), each rank builds
the full-T day tensors or columns, then P, U or `ColumnOperands` for its
n / g outer grid rows only. Every sweep of every query is the rank's
share (K2 or K4 on a CUDA device, the plain twins on the CPU) summed
over the grid ranks exactly and in rank order, so every rank holds the
same bits and returns the full result; the bisection is a loop of such
sweeps (K1 bisects whole days and is not on this path). As in JAX, the
day axis shards the days too only for the MSM family at dim 2 when d
divides T; elsewhere the day rows repeat the work.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from copula_var_tpu_torch.copulas import fit as copula_fit
from copula_var_tpu_torch.data.returns import ReturnsData
from copula_var_tpu_torch.device import resolve_device, synchronize
from copula_var_tpu_torch.models import fit as model_fit
from copula_var_tpu_torch.models import garch as garch_mod
from copula_var_tpu_torch.models import msm as msm_mod
from copula_var_tpu_torch.models import ukf as ukf_mod
from copula_var_tpu_torch.ops.cuda_quadrature import (
    F32,
    F64,
    sweep_operands,
    with_prefix_table,
)
from copula_var_tpu_torch.ops.cuda_quadrature3 import contract3_operands
from copula_var_tpu_torch.ops.cuda_solver import _routes, full_solve
from copula_var_tpu_torch.ops.grids import garch_grid, msm_grid
from copula_var_tpu_torch.ops.quadrature import (
    CopulaSpec,
    garch_day_columns,
    garch_day_tensors,
    garch_integrals,
    garch_integrals_cached,
    msm_day_columns,
    msm_day_tensors,
    msm_integrals,
    msm_integrals_cached,
)
from copula_var_tpu_torch.ops.refine import refine_roots
from copula_var_tpu_torch.ops.special import norm_cdf, norm_pdf
from copula_var_tpu_torch.ops.tcached import column_operands
from copula_var_tpu_torch.parallel.mesh import DayMesh, GridMesh
from copula_var_tpu_torch.parallel.multiprocess import gather_days
from copula_var_tpu_torch.parallel.quadrature import gather_solution
from copula_var_tpu_torch.utils.profiling import count, span

VOL_STATE_ROUND_TOL = 1e-6  # `msm_estimation.py:204-248`
# "xla": the f64 path (the default); "pallas": the f32 engine
ENGINES = ("xla", "pallas")
_PALLAS_SCOPE = ("engine='pallas' requires dim in {2, 3} and an adapter "
                 "with a Pallas/cached-columns path")
_PALLAS_MESH = ("engine='pallas' serves one device or a DayMesh (the JAX "
                "engine 'sharded_pallas'); the JAX package has no f32 "
                "grid-sharded engine, so a GridMesh serves engine='xla' "
                "(its 'grid_sharded')")

# the integration inputs' fields with a leading day axis, cut to a rank's
# block with the transform columns
_DAY_FIELDS = ("forecasts_by_states", "forecast_combos", "forecast_vols")


def _sharded_scope(engine: str) -> str:
    """JAX's refusal of a day-sharded `engine` ("sharded" or
    "sharded_pallas") it has no program for (`backtest.py:1333-1339`)."""
    return (f"engine={engine!r} requires dim == 2 (cached day tensors), "
            "dim >= 3 with a transform-column adapter (engine='sharded'), "
            "or dim == 3 (engine='sharded_pallas')")


def _rows(a, dev):
    """(N, A) or (T, N, A) numpy -> a float64 tensor with the asset axis
    first, on `dev`."""
    return torch.as_tensor(np.moveaxis(np.asarray(a, dtype=np.float64), -1,
                                       0).copy(), device=dev)


def _on(a, like):
    """`a` (array-like or tensor) as a float64 tensor on `like`'s
    device."""
    return torch.as_tensor(a, dtype=torch.float64, device=like.device)


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
    """MSM family (`msm_estimation.py`): mixture marginals over q vol
    states. `k` is carried explicitly; the constructor takes the JAX
    adapter's arguments."""

    name = "msm"

    def __init__(self, k: int = 4, basin_iter: int = 100, seed: int = 0,
                 step_size: float = 0.2, b_values=None,
                 gamma_weight: float = 0.0, b_weight: float = 0.0,
                 bounds=None, reference_quirks: bool = False,
                 polish_max_iter: int = 200):
        self.k = k
        self.basin_iter = basin_iter
        self.seed = seed
        self.step_size = step_size
        self.b_values = b_values
        self.gamma_weight = gamma_weight
        self.b_weight = b_weight
        self.bounds = bounds
        self.reference_quirks = reference_quirks
        self.polish_max_iter = polish_max_iter

    def fit(self, in_sample, device="cuda", timings=None):
        """Every asset's basin hop, polish and final LL in lockstep on
        `device` (asset i seeded `seed + i`)."""
        return model_fit.fit_msm_batch(
            in_sample, self.k, basin_iter=self.basin_iter,
            step_size=self.step_size, b_values=self.b_values,
            gamma_weight=self.gamma_weight, b_weight=self.b_weight,
            seed=self.seed, bounds=self.bounds,
            reference_quirks=self.reference_quirks,
            polish_max_iter=self.polish_max_iter, device=device,
            timings=timings,
        )

    @staticmethod
    def _params(fits, dev):
        """(m_0, sigma, b, gamma), each (A, 1) on `dev`."""
        p = torch.tensor([[f.m_0, f.sigma, f.b, f.gamma] for f in fits],
                         dtype=torch.float64, device=dev)
        return p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]

    def marginals_densities(self, in_sample, fits, device="cuda"):
        """Stacked (N-1, dim) marginals and densities
        (`msm_estimation.py:55-120`; the length drop is the reference's
        alignment shift), every asset in one batched filter."""
        dev = resolve_device(device)
        m0, sigma, b, gm = (v[:, 0] for v in self._params(fits, dev))
        r = _rows(in_sample, dev)
        marg, _, _ = msm_mod.marginals(self.k, m0, sigma, b, gm, r)
        dens = msm_mod.densities(self.k, m0, sigma, b, gm, r)
        return marg.T.cpu().numpy(), dens.T.cpu().numpy()

    def integration_inputs(self, windows, fits, num_points: int,
                           box=(-5.0, 5.0), device="cuda"):
        """Per-day forecast state distributions of all T windows
        (`msm_estimation.py:139-202`), every asset and window in one
        batched filter, collapsed to unique (1e-6-rounded) vol levels
        (`:204-248`), densities on the MSM grid (`:282-330`) and the joint
        combo probabilities in ij order (`:368-418`). Assets with fewer
        unique levels are padded with zero-probability states."""
        dev = resolve_device(device)
        T, N, dim = windows.shape
        m0, sigma, b, gm = self._params(fits, dev)
        fc = msm_mod.forecast_windows(self.k, m0, sigma, b, gm,
                                      _rows(windows, dev))
        forecasts_array = fc.cpu().numpy()  # (dim, T, 2^k)
        vol_state_array = msm_mod.vol_states(
            self.k, m0[:, 0], sigma[:, 0]).cpu().numpy()  # (dim, 2^k)

        fbs_per_dim, uniq_per_dim = [], []
        for i in range(dim):
            rounded = (np.round(vol_state_array[i] / VOL_STATE_ROUND_TOL)
                       * VOL_STATE_ROUND_TOL)
            uniq, inv = np.unique(rounded, return_inverse=True)
            summed = np.zeros((T, len(uniq)))
            np.add.at(summed.T, inv, forecasts_array[i].T)
            fbs_per_dim.append(summed)
            uniq_per_dim.append(uniq)
        q = max(len(u) for u in uniq_per_dim)
        for i in range(dim):
            pad = q - len(uniq_per_dim[i])
            if pad:
                uniq_per_dim[i] = np.concatenate(
                    [uniq_per_dim[i], np.full(pad, uniq_per_dim[i][-1])])
                fbs_per_dim[i] = np.pad(fbs_per_dim[i], ((0, 0), (0, pad)))
        unique_vols = np.stack(uniq_per_dim, axis=0)  # (dim, q)
        fbs = np.stack(fbs_per_dim, axis=1)  # (T, dim, q)

        x, dx = msm_grid(num_points, box[0], box[1])
        densities = norm_pdf(torch.as_tensor(x)[None, None, :],
                             std=torch.as_tensor(unique_vols)[:, :, None]
                             ).numpy()  # (dim, q, n)
        combos = fbs[:, 0, :]
        for d in range(1, dim):
            combos = (combos[:, :, None] * fbs[:, d, None, :]).reshape(T, -1)
        return MsmIntegrationInputs(x, dx, densities, unique_vols, fbs,
                                    combos)

    def integrals(self, bounds, inputs: MsmIntegrationInputs, spec,
                  weights, box_min=-5.0):
        """(T,) integrals over per-day slabs bounds (T, 2), the density
        rebuilt from the inputs (the minimal contract's integrand)."""
        x = inputs.x
        return msm_integrals(
            _on(bounds, x), inputs.forecasts_by_states,
            inputs.forecast_combos, x, inputs.dx, inputs.densities,
            inputs.unique_vols, _on(weights, x), spec, box_min)

    def day_tensors(self, inputs: MsmIntegrationInputs, spec):
        return msm_day_tensors(inputs.forecasts_by_states, inputs.x,
                               inputs.unique_vols, spec)

    def integrals_cached(self, bounds, tensors, inputs, weights,
                         box_min=-5.0):
        return msm_integrals_cached(
            bounds, tensors, inputs.forecast_combos, inputs.x, inputs.dx,
            inputs.densities, weights, box_min,
        )

    def sweep_operands(self, tensors, inputs: MsmIntegrationInputs,
                       rows=None, dtype=F64, table=True, days=None):
        return sweep_operands(tensors, inputs.x, inputs.dx, inputs.densities,
                              inputs.forecast_combos, rows=rows, dtype=dtype,
                              table=table, days=days)

    def day_columns(self, inputs: MsmIntegrationInputs, spec):
        return msm_day_columns(inputs.forecasts_by_states, inputs.x,
                               inputs.unique_vols, spec)

    def contract3_operands(self, cols, inputs: MsmIntegrationInputs, spec,
                           rows=None, dtype=F64, days=None):
        return contract3_operands(cols, inputs.x, inputs.dx, spec,
                                  densities=inputs.densities,
                                  forecast_combos=inputs.forecast_combos,
                                  rows=rows, dtype=dtype, days=days)

    def column_operands(self, cols, inputs: MsmIntegrationInputs, spec,
                        rows=None):
        return column_operands(cols, inputs.x, inputs.dx, spec,
                               densities=inputs.densities,
                               forecast_combos=inputs.forecast_combos,
                               rows=rows)


class GarchAdapter:
    """GARCH family (`garch_estimation.py`): one forecast vol per asset
    and day (q = 1). The constructor takes the JAX adapter's
    arguments."""

    name = "garch"

    def __init__(self, p_max: int = 3, q_max: int = 3,
                 newton_max_iter: int = 200, newton_tol: float = 1e-10,
                 eps: float = 1e-5, reference_quirks: bool = False):
        self.p_max = p_max
        self.q_max = q_max
        self.newton_max_iter = newton_max_iter
        self.newton_tol = newton_tol
        self.eps = eps
        self.reference_quirks = reference_quirks

    def fit(self, in_sample, device="cuda", timings=None):
        """Every asset's BIC sweep in one batched Newton solve on
        `device` (one stage: `timings` gets nothing of its own)."""
        return model_fit.fit_garch_batch(
            in_sample, p_max=self.p_max, q_max=self.q_max,
            max_iter=self.newton_max_iter, tol=self.newton_tol,
            eps=self.eps, reference_quirks=self.reference_quirks,
            device=device,
        )

    @staticmethod
    def _padded_params(fits, dev):
        """(omega (A,), alpha (A, p_max), beta (A, q_max), p (A,), q (A,))
        on `dev`: coefficient rows end-zero-padded to the panel's largest
        lag counts (the same recursion) and the true lag counts for the
        forecast's pairing quirk."""
        pm = max(len(np.atleast_1d(f.alpha)) for f in fits)
        qm = max(len(np.atleast_1d(f.beta)) for f in fits)
        A = len(fits)
        alpha, beta = np.zeros((A, pm)), np.zeros((A, qm))
        p_arr, q_arr = np.zeros(A, np.int64), np.zeros(A, np.int64)
        for i, f in enumerate(fits):
            a_i, b_i = np.atleast_1d(f.alpha), np.atleast_1d(f.beta)
            alpha[i, :len(a_i)], beta[i, :len(b_i)] = a_i, b_i
            p_arr[i], q_arr[i] = len(a_i), len(b_i)
        omega = np.asarray([f.omega for f in fits], dtype=np.float64)
        return tuple(torch.as_tensor(v, device=dev)
                     for v in (omega, alpha, beta, p_arr, q_arr))

    def marginals_densities(self, in_sample, fits, device="cuda"):
        """marginals = Phi(eps_t), densities = phi(eps_t) of the
        standardized residuals (`garch_estimation.py:56-119`), every asset
        in one batched recursion -> (N, dim) each."""
        dev = resolve_device(device)
        omega, alpha, beta, _, _ = self._padded_params(fits, dev)
        eps = garch_mod.standardized_residuals(_rows(in_sample, dev), omega,
                                               alpha, beta)
        return norm_cdf(eps).T.cpu().numpy(), norm_pdf(eps).T.cpu().numpy()

    def integration_inputs(self, windows, fits, num_points: int,
                           box=(-5.0, 5.0), device="cuda"):
        """The one-step forecast vol of every asset and window (T, dim),
        one batched recursion, and the GARCH grid."""
        dev = resolve_device(device)
        omega, alpha, beta, p, q = self._padded_params(fits, dev)
        fv = garch_mod.forecast_vol_padded(
            _rows(windows, dev), omega[:, None], alpha[:, None],
            beta[:, None], p[:, None], q[:, None])  # (dim, T)
        x, dx = garch_grid(num_points, box[0], box[1])
        return GarchIntegrationInputs(x, dx, fv.T.cpu().numpy())

    def integrals(self, bounds, inputs: GarchIntegrationInputs, spec,
                  weights, box_min=-5.0):
        """(T,) integrals over per-day slabs bounds (T, 2), the density
        rebuilt from the forecast vols (the minimal contract's
        integrand)."""
        x = inputs.x
        return garch_integrals(_on(bounds, x), inputs.forecast_vols, x,
                               inputs.dx, _on(weights, x), spec, box_min)

    def day_tensors(self, inputs: GarchIntegrationInputs, spec):
        return garch_day_tensors(inputs.forecast_vols, inputs.x, spec)

    def integrals_cached(self, bounds, tensors, inputs, weights,
                         box_min=-5.0):
        return garch_integrals_cached(bounds, tensors, inputs.x, inputs.dx,
                                      weights, box_min)

    def sweep_operands(self, tensors, inputs: GarchIntegrationInputs,
                       rows=None, dtype=F64, table=True, days=None):
        return sweep_operands(tensors, inputs.x, inputs.dx, rows=rows,
                              dtype=dtype, table=table, days=days)

    def day_columns(self, inputs: GarchIntegrationInputs, spec):
        return garch_day_columns(inputs.forecast_vols, inputs.x, spec)

    def contract3_operands(self, cols, inputs: GarchIntegrationInputs, spec,
                           rows=None, dtype=F64, days=None):
        tcols, p_cols = cols
        return contract3_operands(tcols, inputs.x, inputs.dx, spec,
                                  p_cols=p_cols, rows=rows, dtype=dtype,
                                  days=days)

    def column_operands(self, cols, inputs: GarchIntegrationInputs, spec,
                        rows=None):
        tcols, p_cols = cols
        return column_operands(tcols, inputs.x, inputs.dx, spec,
                               p_cols=p_cols, rows=rows)


class MeanRevertingAdapter(GarchAdapter):
    """UKF mean-reverting family (`mean_reverting_estimation.py`): the
    GARCH integrand (one forecast vol per asset and day, q = 1) with the
    UKF's fit, residuals and forecasts. The constructor takes the JAX
    adapter's arguments and defaults."""

    name = "mean_reverting"

    def __init__(self, em_max_iter: int = 200, seed: int = 0,
                 a0: float = 0.99, l0: float = 0.5, q0: float = 0.1,
                 em_tol: float = 1e-6, perturb_scale: float = 0.05,
                 restart_attempts: int = 5,
                 reference_quirks: bool = False):
        self.em_max_iter = em_max_iter
        self.seed = seed
        self.a0, self.l0, self.q0 = a0, l0, q0
        self.em_tol = em_tol
        self.perturb_scale = perturb_scale
        self.restart_attempts = restart_attempts
        self.reference_quirks = reference_quirks

    def fit(self, in_sample, device="cuda", timings=None):
        """Every asset's EM in lockstep on `device` (asset i seeded
        `seed + i`; one stage: `timings` gets nothing of its own)."""
        return model_fit.fit_ukf_em_batch(
            in_sample, a0=self.a0, l0=self.l0, q0=self.q0,
            max_iter=self.em_max_iter, tol=self.em_tol,
            perturb_scale=self.perturb_scale,
            restart_attempts=self.restart_attempts, seed=self.seed,
            reference_quirks=self.reference_quirks, device=device,
        )

    @staticmethod
    def _params(fits, dev):
        """(a, l, q), each (A,) on `dev`."""
        p = torch.tensor([[f.a, f.l, f.q] for f in fits],
                         dtype=torch.float64, device=dev)
        return p[:, 0], p[:, 1], p[:, 2]

    def marginals_densities(self, in_sample, fits, device="cuda"):
        """marginals = Phi(eps_t), densities = phi(eps_t) of the UKF
        residuals (`mean_reverting_estimation.py:95-106`), every asset in
        one batched filter -> (N, dim) each."""
        dev = resolve_device(device)
        eps = ukf_mod.standardized_residuals(_rows(in_sample, dev),
                                             *self._params(fits, dev))
        return norm_cdf(eps).T.cpu().numpy(), norm_pdf(eps).T.cpu().numpy()

    def integration_inputs(self, windows, fits, num_points: int,
                           box=(-5.0, 5.0), device="cuda"):
        """The UKF's one-step forecast vol of every asset and window
        (T, dim), one batched filter, and the GARCH grid."""
        dev = resolve_device(device)
        a, l, q = self._params(fits, dev)
        fv = ukf_mod.forecast_vol_windows(_rows(windows, dev), a[:, None],
                                          l[:, None], q[:, None])  # (dim, T)
        x, dx = garch_grid(num_points, box[0], box[1])
        return GarchIntegrationInputs(x, dx, fv.T.cpu().numpy())


_ADAPTERS = {"msm": MsmAdapter, "garch": GarchAdapter,
             "mean_reverting": MeanRevertingAdapter}
_COPULA_FITTERS = {
    "gaussian": copula_fit.fit_gaussian,
    "student": copula_fit.fit_student,
    "plackett": copula_fit.fit_plackett,
}
_COPULA_SPEC_BUILDERS = {}


def register_adapter(name: str, adapter_cls) -> None:
    """Plug in a volatility-model adapter (the reference's
    `VaRCalculationMethod`). The minimal contract is JAX's: `fit(
    in_sample, device, timings)`, `marginals_densities(in_sample, fits,
    device)`, `integration_inputs(windows, fits, num_points, box, device)`
    and `integrals(bounds, inputs, spec, weights, box_min)` -> (T,). Such
    an adapter is served by a host bisection over `integrals`
    (`calc_var`, `calc_var_levels`); portfolios, grids and refine_root
    raise, as in JAX. The fast path, through the kernels, takes the
    serving methods of `MsmAdapter` / `GarchAdapter`: `day_tensors` and
    `sweep_operands` at dim 2; `day_columns` and `contract3_operands` at
    dim 3, `column_operands` at dim >= 4 (the operand constructors take
    `rows=(i0, i1)` to serve a grid mesh; at dim 2 and 3 `days=`, a
    slice, to serve a day mesh). An adapter with neither
    `day_tensors` nor `day_columns` takes the minimal route."""
    _ADAPTERS[name] = adapter_cls


def register_copula(name: str, fitter, spec_builder) -> None:
    """Plug in a copula: `fitter(marginals, densities, device=...) -> fit`
    and `spec_builder(fit, device) -> CopulaSpec` of a kind the
    quadrature serves ('gaussian', 'student', 'plackett')."""
    _COPULA_FITTERS[name] = fitter
    _COPULA_SPEC_BUILDERS[name] = spec_builder


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
    if kind in _COPULA_SPEC_BUILDERS:
        return _COPULA_SPEC_BUILDERS[kind](fit_result, device)
    raise ValueError(f"unknown copula: {kind}")


def _mesh_device(device, mesh):
    """The device a backtest serves on: `device` (the card unless the
    caller asks for "cpu"), or with a mesh the rank's own device, whose
    type `device` must name."""
    if mesh is None:
        return resolve_device(device)
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {str(device)!r} but the mesh's ranks serve "
                         f"on {mesh.device}")
    return mesh.device


def _take_days(tree, days):
    """Every tensor leaf of the nested tuple `tree`, cut to `days` on its
    leading axis (a copy, so the full-T build can be freed)."""
    if torch.is_tensor(tree):
        return tree[days].clone()
    return type(tree)(_take_days(t, days) for t in tree)


def _check_options(dim: int, copula: str) -> None:
    """Refuse what neither package serves: a one-asset book, and the
    bivariate Plackett copula above dim 2."""
    if dim < 2:
        raise ValueError(f"a VaR backtest needs two or more assets (got "
                         f"dim={dim})")
    if dim >= 3 and copula == "plackett":
        raise ValueError(
            f"the Plackett copula is bivariate; dim {dim} takes Gaussian "
            "or Student"
        )


class VaRBacktest:
    """Out-of-sample VaR backtest from fitted state.

    data: ReturnsData; adapter: MsmAdapter or GarchAdapter; copula: kind;
    copula_fit / model_fits: fitted records; integration_inputs: the
    adapter's inputs (tensors are moved to `device`, the card unless the
    caller asks for "cpu"); marginals / densities: the in-sample IFM
    inputs, kept for the record. `prep_seconds` counts the fit that made
    the state (`create_var_backtest`) and the sweep operands' build.
    reference_quirks: the reference's stage-2 bracket anchor
    (`ops/solvers.py::bracket_state_batched`); refine_root: the trap
    re-solve of every query (`ops/refine.py`), whose last wall seconds
    are `refine_seconds`. mesh: a `parallel.mesh.DayMesh` to serve this
    rank's block of days and gather every result over the ranks, a
    `parallel.mesh.GridMesh` to serve this rank's outer grid rows and sum
    every sweep over the grid ranks (the backtest then lives on the
    mesh's device), or None for one card. engine: "xla" (the f64 path) or
    "pallas" (the f32 engine, on one card or a `DayMesh`; see the module
    docstring); assigning it drops the built operands.
    """

    def __init__(self, data: ReturnsData, adapter, copula: str, copula_fit,
                 model_fits, integration_inputs, marginals=None,
                 densities=None, num_points=100, box=(-5.0, 5.0),
                 device="cuda", reference_quirks=False, refine_root=False,
                 mesh=None, engine="xla"):
        _check_options(data.dim, copula)
        self.device = _mesh_device(device, mesh)
        self.mesh = mesh
        self._grid = mesh if isinstance(mesh, GridMesh) else None
        self.data = data
        self.adapter = adapter
        self.copula = copula
        self.copula_fit = copula_fit
        self.model_fits = list(model_fits)
        self.num_points = num_points
        self.box = tuple(box)
        self.reference_quirks = bool(reference_quirks)
        self.refine_root = bool(refine_root)
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
        self.engine = engine
        self.prep_seconds = 0.0
        # JAX's minimal plugin contract: no cached path, so every sweep
        # is `adapter.integrals` and the bisection runs on the host
        self.plugin = not (hasattr(adapter, "day_tensors")
                           or hasattr(adapter, "day_columns"))
        if self.plugin and mesh is not None:
            why = ("a plugin adapter without day_tensors / day_columns "
                   "serves on one device (its integrals have no sharded "
                   "form)")
            if isinstance(mesh, DayMesh):
                why = _sharded_scope("sharded_pallas" if engine == "pallas"
                                     else "sharded") + "; " + why
            raise ValueError(why)

    # -- bounds-invariant state ------------------------------------------

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, value: str) -> None:
        """Select "xla" or "pallas"; the operands built for the previous
        engine are dropped (the next query builds the new engine's)."""
        if value not in ENGINES:
            raise ValueError(f"engine={value!r}: VaRBacktest serves "
                             f"{ENGINES} (the day- and grid-sharded engines "
                             "are a mesh: `mesh=`)")
        self._engine = value
        self._ops = None
        self._trap_ops = None

    def _pallas(self) -> bool:
        """True for the f32 engine, once it is known to serve this
        backtest: dim 2 or 3, the MSM or GARCH integrand, on one device
        or a `DayMesh` (the scopes of JAX's "pallas" and "sharded_pallas"
        engines, whose messages it raises)."""
        if self._engine != "pallas":
            return False
        if self.mesh is not None and not isinstance(self.mesh, DayMesh):
            raise ValueError(_PALLAS_MESH)
        if (self.plugin or self.data.dim not in (2, 3)
                or not isinstance(self.integration_inputs,
                                  (MsmIntegrationInputs,
                                   GarchIntegrationInputs))):
            raise ValueError(_PALLAS_SCOPE if self.mesh is None
                             else _sharded_scope("sharded_pallas"))
        return True

    def sweep_operands(self):
        """The sweeps' bounds-invariant operands, built once: day tensors
        and their hoisted contraction at dim 2, transform columns and
        `Contract3Operands` (with the table U on a CUDA device) at dim 3,
        transform columns as `ColumnOperands` at dim >= 4; float32 at
        dim 2 and 3 on the f32 engine. With a mesh, those of this rank's
        block of days, cut from the operands of the full-T day tensors or
        columns, and with a grid mesh those of its outer grid rows."""
        if self.plugin:
            raise ValueError(
                f"adapter {type(self.adapter).__name__} has no cached path "
                "(day_tensors / day_columns): its sweeps are its "
                "`integrals`")
        if self._ops is None:
            t0 = time.perf_counter()
            with span("prep"):
                self._ops = self._build_operands()
                with span("sync.prep"):
                    synchronize(self.device)
            self.prep_seconds += time.perf_counter() - t0
        return self._ops

    def _build_operands(self):
        """`sweep_operands`'s build: the adapter's day tensors or columns
        (span `prep.day_tensors`), then its operands (`prep.operands`)."""
        inputs, spec = self.integration_inputs, self.copula_spec
        kw = ({} if self._grid is None else
              {"rows": self._grid.rows(inputs.x.shape[0])})
        pallas = self._pallas()
        if self.data.dim >= 4:
            with span("prep.day_tensors"):
                cols = self._block(self.adapter.day_columns(inputs, spec))
            with span("prep.operands"):
                return self.adapter.column_operands(
                    cols, self._block_inputs(), spec, **kw)
        kw.update(self._days_kw())
        if pallas:
            kw["dtype"] = F32
        if self.data.dim == 3:
            with span("prep.day_tensors"):
                cols = self.adapter.day_columns(inputs, spec)
            with span("prep.operands"):
                return self.adapter.contract3_operands(cols, inputs, spec,
                                                       **kw)
        with span("prep.day_tensors"):
            tensors = self.adapter.day_tensors(inputs, spec)
        with span("prep.operands"):
            return self.adapter.sweep_operands(tensors, inputs, **kw)

    def _day_mesh(self):
        """The mesh that shards this backtest's days: a `DayMesh`, or a
        grid mesh's day axis where JAX's grid engine shards days (the MSM
        family at dim 2, the axis wider than 1 and dividing T); else
        None."""
        if self._grid is None:
            return self.mesh
        days = self._grid.day_mesh
        if (self.data.dim == 2 and days.size > 1
                and isinstance(self.integration_inputs, MsmIntegrationInputs)
                and self.data.out_sample_n % days.size == 0):
            return days
        return None

    def _days(self):
        """This rank's block of the T days, or None when no mesh shards
        them."""
        mesh = self._day_mesh()
        if mesh is None:
            return None
        return mesh.days(self.data.out_sample_n)

    def _days_kw(self):
        """The operand builders' `days=` of this rank's block, or none."""
        days = self._days()
        return {} if days is None else {"days": days}

    def _block(self, tree):
        days = self._days()
        return tree if days is None else _take_days(tree, days)

    def _block_inputs(self):
        """The integration inputs with their day fields cut to this
        rank's block."""
        inputs, days = self.integration_inputs, self._days()
        if days is None:
            return inputs
        return inputs._replace(**{f: getattr(inputs, f)[days]
                                  for f in _DAY_FIELDS
                                  if f in inputs._fields})

    def _gather(self, roots, nan_days):
        """The (L, T) series with NaN days masked, gathered from every
        rank's block when a mesh shards the days."""
        mesh = self._day_mesh()
        if mesh is not None:
            roots, nan_days = gather_solution(roots, nan_days, mesh,
                                              self.data.out_sample_n)
        return torch.where(nan_days, torch.full_like(roots, np.nan), roots)

    def _series(self, roots, nan_days, means):
        """The (L, T) series in host memory: `_gather`'s, read back (one
        host read), plus the portfolio `means`."""
        with span("solve.gather"):
            out = self._gather(roots, nan_days)
            with span("sync.gather"):
                out = out.cpu().numpy()
            return out + means

    def _tensor(self, a):
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            dtype=torch.float64, device=self.device)

    def compute_integral(self, bounds) -> np.ndarray:
        """(T,) integrals over per-day [lower, upper] slabs (T, 2): one
        sweep, through the kernel on a CUDA device at dim 2 and 3 (in
        float32 on the f32 engine, as JAX's K3 / K4; on a day mesh, as
        JAX's "sharded_pallas", in float64 at dim 2); for a plugin adapter
        its `integrals` (plain PyTorch, as JAX's XLA)."""
        self._pallas()  # the f32 engine's scope errors
        if self.plugin:
            out = self.adapter.integrals(
                self._tensor(bounds).reshape(-1, 2), self.integration_inputs,
                self.copula_spec, self.weights, self.box[0])
            with span("sync.integral"):
                return torch.as_tensor(out).cpu().numpy()
        b = self._block(self._tensor(bounds).reshape(-1, 2))
        ops = (self._f64_operands(table=True)
               if self.data.dim == 2 and self.mesh is not None
               else self.sweep_operands())
        dt = ops.x.dtype
        sweep, _ = _routes(ops, False)
        out = sweep(ops, b[None].to(dt).contiguous(),
                    self.weights.reshape(1, -1).to(dt), self.box[0])[0]
        if self._grid is not None:
            out = self._grid.grid_sum(out)
        if self._day_mesh() is not None:
            out = gather_days(out, self._day_mesh(), self.data.out_sample_n)
        with span("sync.integral"):
            return out.cpu().numpy()

    @staticmethod
    def adjust_integral(new_result, prev_results, bounds, prev_upper):
        """Incremental CDF bookkeeping: add the slab when its lower edge
        continues the previous upper bound, else subtract it (numpy
        arrays or tensors)."""
        add = bounds[:, 0] == prev_upper
        where = torch.where if torch.is_tensor(new_result) else np.where
        return where(add, prev_results + new_result,
                     prev_results - new_result)

    # -- VaR solve --------------------------------------------------------

    def _cfg(self, first_guess, second_guess, min_var_value, max_var_value):
        return (float(first_guess), float(second_guess[0]),
                float(second_guess[1]), float(min_var_value),
                float(max_var_value))

    def calc_var_levels(self, obj_vars=(0.01, 0.025, 0.05), first_guess=-3.0,
                        second_guess=(-3.5, -2.0), tolerance=1e-6,
                        min_var_value=-7.5, max_var_value=0.0,
                        verbose=False):
        """VaR at L confidence levels in one batched solve -> (L, T);
        row l equals `calc_var(obj_vars[l])`. A plugin adapter's levels
        are bisected one by one on the host (`verbose` prints each
        halving's widest gap, as JAX's `_bisection`)."""
        self._pallas()  # the f32 engine's scope errors
        if self.plugin:
            return self._host_levels(obj_vars, first_guess, second_guess,
                                     tolerance, min_var_value,
                                     max_var_value, verbose)
        with span("solve"):
            obj = self._tensor(np.atleast_1d(obj_vars))
            t0 = time.perf_counter()
            cfg = self._cfg(first_guess, second_guess, min_var_value,
                            max_var_value)
            roots, nan_days = full_solve(
                self.sweep_operands(), obj, self.weights, cfg, tolerance,
                self.reference_quirks, self.box[0], self._day_mesh(),
                self._grid)
            if self.refine_root:
                L = roots.shape[0]
                roots = self._refine(roots, obj, self.weights.expand(L, -1),
                                     np.full(L, self._plateau_h()))
            out = self._series(roots, nan_days, self.data.ptf_mean)
        self.solve_seconds = time.perf_counter() - t0
        return out

    def calc_var(self, obj_var=0.05, first_guess=-3.0,
                 second_guess=(-3.5, -2.0), tolerance=1e-6,
                 min_var_value=-7.5, max_var_value=0.0, verbose=False):
        """Three-stage VaR solve (`calc_var_class.py:95-177,250-309`):
        slab [-100, first_guess], one refinement slab, bisection to
        `tolerance`, plus the portfolio mean -> (T,). `verbose` prints the
        host bisection's halvings of a plugin adapter."""
        return self.calc_var_levels(
            [obj_var], first_guess, second_guess, tolerance, min_var_value,
            max_var_value, verbose,
        )[0]

    # -- the minimal-plugin route (JAX `_bracket` / `_bisection`) ----------

    def _host_levels(self, obj_vars, first_guess, second_guess, tolerance,
                     min_var_value, max_var_value, verbose):
        """(L, T) VaR of a plugin adapter: the shared stage-1 sweep, each
        level's stage-2 bracket and its host bisection over `integrals`
        (JAX `calc_var_levels` without a cached integral)."""
        if self.refine_root:
            raise ValueError(
                "refine_root is not supported for adapter "
                f"{type(self.adapter).__name__}: a plugin adapter without "
                "a cached path (day_tensors / day_columns) has no trapezoid "
                "twin and cannot refine")
        T = self.data.out_sample_n
        obj_vars = np.atleast_1d(np.asarray(obj_vars, dtype=np.float64))
        t0 = time.perf_counter()
        with span("solve"):
            bounds = np.column_stack((np.full(T, -100.0),
                                      np.full(T, first_guess)))
            with span("solve.stage1"):
                results = self.compute_integral(bounds)
            final = []
            for ov in obj_vars:
                with span("solve.bracket"):
                    bis, res, upper_stack, prev_upper, nan_days = \
                        self._bracket(ov, results, first_guess, second_guess,
                                      min_var_value, max_var_value)
                with span("solve.bisect"):
                    roots = self._bisection(ov, bis, res, upper_stack,
                                            prev_upper, tolerance, verbose)
                final.append(np.where(nan_days, np.nan, roots))
        self.solve_seconds = time.perf_counter() - t0
        return np.stack(final) + self.data.ptf_mean

    def _bracket(self, obj_var, results, first_guess, second_guess,
                 min_var_value, max_var_value):
        """Stage-2 refinement and bisection set-up for one level, given
        the stage-1 CDF at `first_guess` (JAX `VaRBacktest._bracket`, the
        reference's add-group anchor under `reference_quirks`). Returns
        (bisection bounds (T, 2), result, upper_stack, prev_upper,
        nan_days)."""
        T = self.data.out_sample_n
        new_lower = np.where(results >= obj_var, second_guess[0], first_guess)
        new_upper = np.where(results < obj_var, second_guess[1], first_guess)
        bounds = np.column_stack((new_lower, new_upper))
        add_anchor = first_guess if self.reference_quirks else second_guess[1]
        prev_upper = np.where(new_lower == second_guess[0], second_guess[0],
                              add_anchor)
        result = self.adjust_integral(self.compute_integral(bounds),
                                      results, bounds, np.full(T, first_guess))
        upper = bounds[:, 1]
        bis = np.tile(np.array([min_var_value, max_var_value]), (T, 1))
        nan_days = np.isnan(result)
        hi = result > obj_var
        bis[hi, 0], bis[hi, 1] = min_var_value, second_guess[0]
        m = (result < obj_var) & (upper == first_guess)
        bis[m, 0], bis[m, 1] = second_guess[0], first_guess
        m = (result < obj_var) & (upper == second_guess[1])
        bis[m, 0], bis[m, 1] = second_guess[1], max_var_value
        m = (result > obj_var) & (upper == second_guess[1])
        bis[m, 0], bis[m, 1] = first_guess, second_guess[1]
        upper_stack = ~np.isin(bis[:, 1], list(second_guess))
        return bis, result, upper_stack, prev_upper, nan_days

    def _bisection(self, obj_var, bisection_bounds, prev_result, upper_stack,
                   prev_upper, tolerance=1e-6, verbose=False):
        """Whole-array bisection on the host, one `integrals` sweep per
        halving, with the early break when every day's CDF is exactly 0
        (JAX `VaRBacktest._bisection`, `calc_var_class.py:250-309`)."""
        lower = bisection_bounds[:, 0].copy()
        upper = bisection_bounds[:, 1].copy()
        it = 0
        while np.any(upper - lower > tolerance):
            mid = (lower + upper) / 2.0
            bounds = np.where(upper_stack[:, None],
                              np.column_stack((lower, mid)),
                              np.column_stack((mid, upper)))
            result = self.adjust_integral(self.compute_integral(bounds),
                                          prev_result, bounds, prev_upper)
            count("solve.halvings")
            if np.all(result == 0):
                break
            upper_stack = result < obj_var
            lower = np.where(~upper_stack, lower, mid)
            upper = np.where(upper_stack, upper, mid)
            prev_result = result
            prev_upper = mid
            it += 1
            if verbose:
                print(f"bisection iter {it}: gap {np.max(upper - lower):.2e}")
        return (lower + upper) / 2.0

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
        self._pallas()  # the f32 engine's scope errors
        if self.plugin:
            raise ValueError(
                "calc_var_portfolios needs a cached integral (the adapter's "
                "day_tensors at dim 2, day_columns at dim >= 3); adapter "
                f"{type(self.adapter).__name__} has only `integrals`, which "
                "serves calc_var and calc_var_levels")
        L = weights_batch.shape[0]
        obj = np.broadcast_to(np.atleast_1d(np.asarray(obj_var, float)), (L,))
        t0 = time.perf_counter()
        with span("solve"):
            obj, w_rows = self._tensor(obj), self._tensor(weights_batch)
            cfg = self._cfg(first_guess, second_guess, min_var_value,
                            max_var_value)
            roots, nan_days = full_solve(
                self.sweep_operands(), obj, w_rows.contiguous(), cfg,
                tolerance, self.reference_quirks, self.box[0],
                self._day_mesh(), self._grid)
            if self.refine_root:
                roots = self._refine(roots, obj, w_rows,
                                     self._plateau_h(weights_batch))
            ptf_means = np.asarray(self.data.in_sample_mean) @ weights_batch.T
            out = self._series(roots, nan_days, ptf_means[:, None])
        self.solve_seconds = time.perf_counter() - t0
        return out

    def _plateau_h(self, weights=None):
        """Half-width of the refinement window: one grid cell times
        |weights[0]| (the data's weights, or each row's of (L, dim)
        `weights`); the staircase and the continuous root lie within it."""
        w0 = (np.asarray(self.data.weights)[0] if weights is None
              else np.asarray(weights)[..., 0])
        return float(self.integration_inputs.dx.max()) * np.abs(w0)

    def _f64_operands(self, table=False):
        """The float64 operands the f32 engine reads beside its own (the
        engine's own on the f64 engine): those it was cast from, of this
        rank's days on a day mesh, built once and without a kernel table
        (the day tensors at dim 2, as JAX's `_refine_fused`; the transform
        columns at dim 3, as its `_refine_dim3_pallas`), which the trap
        re-solve reads. With `table`, at dim 2 on a CUDA device, their
        prefix table P too, built once: the f64 K2 sweep of
        `compute_integral` on a day mesh."""
        if not self._pallas():
            return self.sweep_operands()
        if self._trap_ops is None:
            inputs, spec = self.integration_inputs, self.copula_spec
            if self.data.dim == 2:
                self._trap_ops = self.adapter.sweep_operands(
                    self.adapter.day_tensors(inputs, spec), inputs,
                    table=False, **self._days_kw())
            else:
                self._trap_ops = self.adapter.column_operands(
                    self._block(self.adapter.day_columns(inputs, spec)),
                    self._block_inputs(), spec)
        if table and self.data.dim == 2 and self.device.type == "cuda":
            self._trap_ops = with_prefix_table(self._trap_ops)
        return self._trap_ops

    def _refine(self, roots, obj, weights, h):
        """The trap re-solve of the staircase roots (L, T) for obj (L,),
        weights (L, dim) and half-widths h (L,), in float64 on either
        engine; its wall seconds (device synchronized) go to
        `refine_seconds`."""
        if not isinstance(self.integration_inputs,
                          (MsmIntegrationInputs, GarchIntegrationInputs)):
            raise ValueError(
                "refine_root needs a trapezoid twin of the sweep: the MSM "
                "or GARCH integrand (MsmIntegrationInputs or "
                "GarchIntegrationInputs); a plugin adapter with inputs "
                f"{type(self.integration_inputs).__name__} cannot refine")
        t0 = time.perf_counter()
        with span("solve.refine"):
            out = refine_roots(self._f64_operands(), roots.to(F64), obj,
                               weights, self._tensor(h), self.box[0],
                               self._grid)
            with span("sync.refine"):
                synchronize(self.device)
        self.refine_seconds = time.perf_counter() - t0
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


def create_var_backtest(
    data: ReturnsData,
    estimation_type: str,
    copula_type: str,
    num_points: int = 100,
    box: tuple = (-5.0, 5.0),
    copula_fit_kwargs: Optional[dict] = None,
    model_fits_override: Optional[list] = None,
    copula_fit_override: Optional[object] = None,
    refine_root: bool = False,
    device="cuda",
    mesh=None,
    engine: str = "xla",
    **adapter_kwargs,
) -> VaRBacktest:
    """Fit and build a solve-ready backtest on `device` (the card unless
    the caller asks for "cpu"; the device picks the path): model fit per
    asset -> in-sample marginals and densities -> IFM copula fit ->
    integration inputs of every out-of-sample window -> `VaRBacktest`.

    model_fits_override / copula_fit_override inject fitted records and
    skip that fit (resume from saved artifacts, or reuse one family's fits
    across copulas). `refine_root` and `engine` ("xla" or "pallas") go to
    `VaRBacktest`. `prep_seconds`
    covers the whole preparation, as in the JAX package; `prep_stages`
    holds each step's wall seconds (the device synchronized at each end),
    with the fit's own stages. With a `mesh` every rank fits on its own
    device, then all take rank 0's fitted state (a `broadcast`) and serve
    their blocks of days (a `DayMesh`) or outer grid rows (a
    `GridMesh`); engine "pallas" on a `DayMesh` is the JAX engine
    "sharded_pallas"."""
    if estimation_type not in _ADAPTERS:
        raise ValueError(f"Unsupported estimation type: {estimation_type}")
    if copula_type not in _COPULA_FITTERS:
        raise ValueError(f"Unsupported copula type: {copula_type}")
    _check_options(data.dim, copula_type)
    dev = _mesh_device(device, mesh)
    adapter = _ADAPTERS[estimation_type](**adapter_kwargs)
    stages = {}
    t0 = clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        synchronize(dev)
        now = time.perf_counter()
        stages[name] = now - clock
        clock = now

    in_sample = data.in_sample
    if model_fits_override is not None:
        fits = list(model_fits_override)
    else:
        fits = adapter.fit(in_sample, device=dev, timings=stages)
    lap("model_fit")
    marginals, densities = adapter.marginals_densities(in_sample, fits,
                                                       device=dev)
    lap("marginals_densities")
    if copula_fit_override is not None:
        cfit = copula_fit_override
    else:
        cfit = _COPULA_FITTERS[copula_type](
            marginals, densities, device=dev, **(copula_fit_kwargs or {}))
    lap("copula_fit")
    inputs = adapter.integration_inputs(data.rolling_windows(), fits,
                                        num_points, box, device=dev)
    lap("integration_inputs")
    if mesh is not None:
        host = type(inputs)(*[v.cpu().numpy() if torch.is_tensor(v) else v
                              for v in inputs])
        fits, marginals, densities, cfit, inputs = mesh.broadcast_object(
            (fits, marginals, densities, cfit, host))
        lap("broadcast")
    bt = VaRBacktest(data, adapter, copula_type, cfit, fits, inputs,
                     marginals=marginals, densities=densities,
                     num_points=num_points, box=box, device=dev,
                     refine_root=refine_root, mesh=mesh, engine=engine)
    bt.prep_seconds = time.perf_counter() - t0
    bt.prep_stages = stages
    return bt
