"""Gaussian copula: density and IFM log-likelihood (counterpart of
`copula_var_tpu/copulas/gaussian.py`).

  c(u) = MVN_pdf(Phi^-1(u); Sigma) / prod_i phi(Phi^-1(u_i))
(`gaussian/gaussian.py:47-117`), the IFM log-likelihood with its 1e-10
density floor (`gaussian/inference_for_margins.py:34-53`) and the
penalized negative log-likelihood (`gaussian/opti.py:30-56`). The
quadratic form and determinant come from the Cholesky factor. The NLL
takes a leading batch of parameter rows.
"""

from __future__ import annotations

import torch

from copula_var_tpu_torch.copulas.common import (
    PENALTY,
    chol_quad_logdet,
    corr_matrix_from_params,
    safe_corr,
)
from copula_var_tpu_torch.ops.special import norm_ppf


def log_density(u, corr):
    """log Gaussian copula density of u (N, d) under corr (..., d, d) ->
    (..., N): -1/2 (log det Sigma + z^T (Sigma^-1 - I) z), z = Phi^-1(u)."""
    z = norm_ppf(u)
    quad, logdet = chol_quad_logdet(corr, z)
    return -0.5 * (logdet[..., None] + quad - torch.sum(z * z, -1))


def copula_density(u, corr):
    """Gaussian copula density (`gaussian.py:47-61`)."""
    return torch.exp(log_density(u, corr))


def ifm_log_likelihood(marginals, densities, corr):
    """sum log f_i + sum log max(c, 1e-10)
    (`inference_for_margins.py:48-53`; the floor is Gaussian-specific)."""
    c = torch.clamp_min(copula_density(marginals, corr), 1e-10)
    return torch.sum(torch.log(densities)) + torch.sum(torch.log(c), -1)


def negative_log_likelihood(corr_params, marginals, densities, dim: int):
    """Penalized NLL over packed correlation rows (..., n_par) -> (...):
    non-PD or non-finite matrices return 1e10 (`gaussian/opti.py:30-56`)."""
    ok, corr = safe_corr(corr_matrix_from_params(corr_params, dim))
    nll = -ifm_log_likelihood(marginals, densities, corr)
    return torch.where(ok, nll, torch.full_like(nll, PENALTY))
