"""Student-t copula: density and IFM log-likelihood (counterpart of
`copula_var_tpu/copulas/student.py`).

  c(u) = MVT_pdf(T_nu^-1(u); Sigma, nu) / prod_i t_pdf(T_nu^-1(u_i))
(`student/student.py:49-174`), with the port's own `t_ppf` and
`torch.lgamma` (the JAX module's `betaln` errs by up to ~5e-8 at large nu,
ROADMAP.md section 3, so the two agree to ~1e-9 here, not to the last
bits). Where any coordinate's transform is non-finite the reference
zeroes both pdfs, making the ratio NaN (0/0); that NaN is kept.

The losses take leading batches: parameter rows, and per-row nu with its
transforms.
"""

from __future__ import annotations

import math

import torch

from copula_var_tpu_torch.copulas.common import (
    PENALTY,
    chol_quad_logdet,
    corr_matrix_from_params,
    safe_corr,
)
from copula_var_tpu_torch.ops.special import (
    t_pdf,  # noqa: F401  (re-exported: the JAX module's name)
    t_ppf,
)


def _log_norm(nu, d):
    """lgamma((nu + d)/2) - lgamma(nu/2) - d/2 log(nu pi), nu (...)."""
    return (torch.lgamma((nu + d) / 2.0) - torch.lgamma(nu / 2.0)
            - (d / 2.0) * torch.log(nu * math.pi))


def _log_uni(z, nu):
    """Log univariate-t pdf of z (..., N, d) with nu (...) -> same shape."""
    nu = nu[..., None, None]
    return _log_norm(nu, 1) - ((nu + 1.0) / 2.0) * torch.log1p(z * z / nu)


def precompute_transform(marginals, nu):
    """The per-(data, nu) constants of the IFM loss: the ppf transform
    and the univariate log-pdf sum, for nu of any batch shape (...).
    Returns (z (..., N, d) zero where non-finite, finite (..., N),
    log_uni_sum (..., N))."""
    u = marginals
    nu = torch.as_tensor(nu, dtype=u.dtype, device=u.device)
    x = t_ppf(u.expand(nu.shape + u.shape), nu[..., None, None])
    finite = torch.isfinite(x).all(-1)
    z = torch.where(finite[..., None], x, torch.zeros_like(x))
    return z, finite, _log_uni(z, nu).sum(-1)


def _log_c(z, finite, log_uni_sum, nu, corr, dim):
    quad, logdet = chol_quad_logdet(corr, z)
    log_mvt = (_log_norm(nu, dim)[..., None] - 0.5 * logdet[..., None]
               - ((nu[..., None] + dim) / 2.0) * torch.log1p(
                   quad / nu[..., None]))
    return torch.where(finite, log_mvt - log_uni_sum,
                       torch.full_like(log_mvt, math.nan))


def copula_density(u, nu, corr):
    """Student-t copula density of u (N, d) under nu (float) and corr
    (d, d) -> (N,) (`student.py:49-79`); NaN where any coordinate's
    transform is non-finite."""
    d = corr.shape[-1]
    nu = torch.as_tensor(nu, dtype=u.dtype, device=u.device)
    z, finite, lus = precompute_transform(u, nu)
    return torch.exp(_log_c(z, finite, lus, nu, corr, d))


def ifm_log_likelihood(marginals, densities, nu, corr):
    """sum log f_i + sum log c (no floor for Student;
    `student/inference_for_margins.py:38-55`)."""
    c = copula_density(marginals, nu, corr)
    return torch.sum(torch.log(densities)) + torch.sum(torch.log(c), -1)


def negative_log_likelihood_from_transform(
    corr_params, z, finite, log_uni_sum, nu, log_density_sum, dim: int
):
    """Penalized IFM NLL from precomputed transforms (no ppf inside), for
    rows (...): corr_params (..., n_par), z (..., N, d), finite and
    log_uni_sum (..., N), nu (...). `log_density_sum` is the constant
    sum(log densities) term."""
    ok, corr = safe_corr(corr_matrix_from_params(corr_params, dim))
    log_c = _log_c(z, finite, log_uni_sum, nu, corr, dim)
    nll = -(log_density_sum + torch.sum(log_c, -1))
    return torch.where(ok, nll, torch.full_like(nll, PENALTY))


def negative_log_likelihood(params, marginals, densities, dim: int):
    """Penalized NLL over packed rows (..., 1 + n_par) = (nu, corr params)
    (`student/opti.py:34-64`)."""
    params = torch.as_tensor(params, dtype=torch.float64)
    return negative_log_likelihood_fixed_nu(
        params[..., 1:], params[..., 0], marginals, densities, dim
    )


def negative_log_likelihood_fixed_nu(corr_params, nu, marginals, densities,
                                     dim: int):
    """Penalized NLL over corr_params (..., n_par) at nu (...), with the
    transforms formed for each row's nu."""
    nu = torch.as_tensor(nu, dtype=marginals.dtype, device=marginals.device)
    z, finite, lus = precompute_transform(marginals, nu)
    lds = torch.sum(torch.log(densities))
    return negative_log_likelihood_from_transform(
        corr_params, z, finite, lus, nu, lds, dim)
