"""IFM copula fits (counterpart of `copula_var_tpu/copulas/fit.py`).

The staged schedules of the JAX module, on the caller's device:
  * Gaussian: dim 2, one golden-section scan of rho over [-0.99, 0.99]
    (90 contractions); dim >= 3, `box_lbfgs_batch` from x0 = 0.5 in the
    box +-0.99 (`copulas/gaussian/opti.py:79-128`).
  * Student-t: stage 1, correlations per nu in linspace(2.1, 30, 10) (dim
    2: every nu's rho profile in one lockstep golden-section scan, the
    t_ppf transforms formed once per nu; dim >= 3: `box_lbfgs_batch` over
    the nu grid); stage 2, nu by a golden-section scan of 28 contractions
    over the winning grid point's neighbour cell, with the correlations
    fixed (`copulas/student/opti.py:87-184`). The final nll comes from the
    full NLL.
  * Plackett: one golden-section scan over 10 log-spaced brackets of
    [0.1, 1e4], or over a user's theta_range (`plackett/opti.py:44-97`).

Marginals and densities arrive as numpy (or tensors) and are moved to
`device`, the card unless the caller asks for "cpu". Results are the
JAX module's records, with numpy fields.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from copula_var_tpu_torch.copulas import gaussian, plackett, student
from copula_var_tpu_torch.device import resolve_device
from copula_var_tpu_torch.ops.lbfgs import box_lbfgs_batch
from copula_var_tpu_torch.ops.solvers import _GR, golden_section_min

NU_GRID = np.linspace(2.1, 30, 10)  # `student/opti.py:9`
THETA_GRID = np.linspace(0.5, 50, 10)  # `plackett/opti.py:66`


class GaussianFit(NamedTuple):
    corr_matrix: np.ndarray
    nll: float
    packed_params: np.ndarray  # upper-triangle rho vector


class StudentFit(NamedTuple):
    nu: float
    corr_matrix: np.ndarray
    nll: float
    packed_params: np.ndarray  # [nu, rho...]


class PlackettFit(NamedTuple):
    theta: float
    nll: float
    packed_params: np.ndarray  # [theta]


def _gs_iters(span, tol, default, max_iter=5000):
    """Golden-section iteration count honoring a user's `tol` (a
    parameter-bracket width): tol=None -> `default`; otherwise the
    contractions that bring `span` below tol,
    ceil(log(span / tol) / log(1 / GR)), capped by max_iter."""
    if tol is None:
        it = int(default)
    else:
        span = max(float(span), float(tol))
        it = max(1, int(math.ceil(
            math.log(span / float(tol)) / math.log(1.0 / _GR)
        )))
    return int(min(it, int(max_iter)))


def _inputs(marginals, densities, device):
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64) if not
                               torch.is_tensor(a) else a,
                               dtype=torch.float64, device=dev)

    return t(marginals), t(densities), dev


def _corr(x, dim):
    corr = np.eye(dim)
    il = np.tril_indices(dim, k=-1)
    corr[il] = x
    corr[(il[1], il[0])] = x
    return corr


def fit_gaussian(marginals, densities, tol=None, max_iter=5000,
                 device="cuda") -> GaussianFit:
    """Gaussian IFM fit. tol=None -> the calibrated defaults (dim-2 scan:
    90 contractions; dim >= 3 L-BFGS: 1e-8); a user tol sizes the dim-2
    scan and is the L-BFGS stopping tolerance at dim >= 3."""
    m, d, dev = _inputs(marginals, densities, device)
    dim = m.shape[1]
    n_par = dim * (dim - 1) // 2
    if dim == 2:
        iters = _gs_iters(1.98, tol, default=90, max_iter=max_iter)
        x, nll_v = golden_section_min(
            lambda rho: gaussian.negative_log_likelihood(rho[:, None], m, d,
                                                         2),
            m.new_tensor([-0.99]), m.new_tensor([0.99]), iters)
        x = x.cpu().numpy()
        nll = float(nll_v[0])
    else:
        rho, nll_v = box_lbfgs_batch(
            lambda r: gaussian.negative_log_likelihood(r, m, d, dim),
            torch.full((n_par,), -0.99, dtype=m.dtype, device=dev),
            torch.full((n_par,), 0.99, dtype=m.dtype, device=dev),
            torch.full((1, n_par), 0.5, dtype=m.dtype, device=dev),
            max_iter=int(max_iter), tol=1e-8 if tol is None else float(tol),
        )
        x = rho[0].cpu().numpy()
        nll = float(nll_v[0])
    corr = _corr(x, dim)
    return GaussianFit(corr, nll, corr[np.triu_indices(dim, k=1)])


def fit_student(marginals, densities, nu_values=None, nu_bounds=(2.01, 50.0),
                tol=None, max_iter=5000, device="cuda") -> StudentFit:
    """Student-t IFM fit. tol=None -> calibrated defaults (stage 1: a
    90-contraction rho scan at dim 2, L-BFGS to 1e-9 at dim >= 3; stage
    2: 28 contractions, ~1e-5 in nu). A user tol sizes the stage-2 nu
    bracket, the dim-2 rho scan and the dim >= 3 stage-1 stop."""
    m, d, dev = _inputs(marginals, densities, device)
    dim = m.shape[1]
    n_par = dim * (dim - 1) // 2
    nu_grid = np.asarray(NU_GRID if nu_values is None else nu_values,
                         dtype=float)
    nu_arr = torch.as_tensor(nu_grid, device=dev)
    B = len(nu_grid)
    log_density_sum = torch.sum(torch.log(d))
    # stage 1: the transforms of every grid nu, formed once
    z, fin, lus = student.precompute_transform(m, nu_arr)
    if dim == 2:
        def f_rho(rho):  # (k*B,) -> (k*B,): the probes come in pairs
            k = rho.shape[0] // B
            return student.negative_log_likelihood_from_transform(
                rho[:, None], z.repeat(k, 1, 1), fin.repeat(k, 1),
                lus.repeat(k, 1), nu_arr.repeat(k), log_density_sum, 2)

        rho_b, nll_b = golden_section_min(
            f_rho, torch.full((B,), -0.99, device=dev, dtype=m.dtype),
            torch.full((B,), 0.99, device=dev, dtype=m.dtype),
            _gs_iters(1.98, tol, default=90, max_iter=max_iter))
        rho_b = rho_b[:, None]
    else:
        rho_b, nll_b = box_lbfgs_batch(
            lambda r, z_, f_, l_, n_: student.
            negative_log_likelihood_from_transform(
                r, z_, f_, l_, n_, log_density_sum, dim),
            torch.full((n_par,), -0.99, dtype=m.dtype, device=dev),
            torch.full((n_par,), 0.99, dtype=m.dtype, device=dev),
            torch.full((B, n_par), 0.5, dtype=m.dtype, device=dev),
            batched_args=(z, fin, lus, nu_arr),
            max_iter=int(max_iter), tol=1e-9 if tol is None else float(tol),
        )
    stage1 = nll_b.cpu().numpy()
    i_best = int(np.argmin(np.where(np.isfinite(stage1), stage1, np.inf)))
    # as the JAX module: at dim 2 the correlations come from the plain
    # argmin (a NaN profile wins there), the nu bracket from the finite one
    i_rho = int(np.argmin(stage1)) if dim == 2 else i_best
    best_corr_params = rho_b[i_rho].cpu().numpy()
    # stage 2: nu on the winning grid point's neighbour cell
    lo_nu = nu_grid[i_best - 1] if i_best > 0 else float(nu_bounds[0])
    hi_nu = (nu_grid[i_best + 1] if i_best < len(nu_grid) - 1
             else float(nu_bounds[1]))
    corr_fixed = rho_b[i_rho]
    nu_star, _ = golden_section_min(
        lambda nu: student.negative_log_likelihood_fixed_nu(
            corr_fixed.expand(nu.shape[0], n_par), nu, m, d, dim),
        m.new_tensor([lo_nu]), m.new_tensor([hi_nu]),
        _gs_iters(hi_nu - lo_nu, tol, default=28, max_iter=max_iter))
    nu_opt = float(nu_star[0])
    final_nll = float(student.negative_log_likelihood(
        m.new_tensor(np.concatenate(([nu_opt], best_corr_params))), m, d,
        dim))
    corr = _corr(best_corr_params, dim)
    packed = np.concatenate(([nu_opt], corr[np.triu_indices(dim, k=1)]))
    return StudentFit(nu_opt, corr, final_nll, packed)


def fit_plackett(marginals, densities, theta_range=None, tol=None,
                 max_iter=5000, device="cuda") -> PlackettFit:
    """Plackett IFM fit: one golden-section scan over sub-brackets of
    theta. theta_range=None -> 10 log-spaced brackets over [0.1, 1e4]; a
    user's theta_range is searched exactly, one bracket between each pair
    of consecutive sorted values (clipped at the theta >= 0.1 bound; a
    single value v gives [max(0.1, v/2), 2v]). tol sizes the per-bracket
    contraction count (default 90)."""
    m, d, dev = _inputs(marginals, densities, device)
    if theta_range is None:
        edges = np.exp(np.linspace(np.log(0.1), np.log(1e4),
                                   len(THETA_GRID) + 1))
    else:
        tr = np.unique(np.clip(np.asarray(theta_range, dtype=float), 0.1,
                               None))
        if tr.size == 0:
            raise ValueError("theta_range is empty")
        edges = (np.array([max(0.1, tr[0] / 2.0), tr[0] * 2.0])
                 if tr.size == 1 else tr)
    iters = _gs_iters(float(np.max(np.diff(edges))), tol, default=90,
                      max_iter=max_iter)
    th, nll_v = golden_section_min(
        lambda theta: plackett.negative_log_likelihood(theta, m, d),
        m.new_tensor(edges[:-1]), m.new_tensor(edges[1:]), iters)
    nll_v = nll_v.cpu().numpy()
    nll_v = np.where(np.isfinite(nll_v), nll_v, np.inf)
    i = int(np.argmin(nll_v))
    best_theta = float(th[i])
    return PlackettFit(best_theta, float(nll_v[i]), np.array([best_theta]))
