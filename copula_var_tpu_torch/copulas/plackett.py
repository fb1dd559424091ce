"""Plackett copula (strictly bivariate): density and IFM log-likelihood
(counterpart of `copula_var_tpu/copulas/plackett.py`).

The reference's denominator [(1 + (theta-1)(u+v)) (1 + (theta-1)(1-u-v))]^2
differs from the textbook Plackett density; it is reproduced, as the
JAX module does, because parity is defined against its outputs.
"""

from __future__ import annotations

import torch

from copula_var_tpu_torch.copulas.common import PENALTY


def copula_density(u, theta):
    """Plackett density of u (N, 2) under theta (...) -> (..., N)
    (`plackett.py:45-71`)."""
    if u.shape[-1] != 2:
        raise ValueError(
            "Plackett copula is only defined for 2-dimensional marginals."
        )
    theta = torch.as_tensor(theta, dtype=u.dtype, device=u.device)[..., None]
    a, b = u[..., 0], u[..., 1]
    tm1 = theta - 1.0
    num = theta * (1.0 + tm1 * (a + b - 2.0 * a * b))
    denom = ((1.0 + tm1 * (a + b)) * (1.0 + tm1 * (1.0 - a - b))) ** 2
    return num / denom


def ifm_log_likelihood(marginals, densities, theta):
    """sum log f_i + sum log c (`plackett/inference_for_margins.py:41-49`)."""
    c = copula_density(marginals, theta)
    return torch.sum(torch.log(densities)) + torch.sum(torch.log(c), -1)


def negative_log_likelihood(theta, marginals, densities):
    """NLL over theta (...) -> (...), non-finite values guarded with the
    1e10 penalty."""
    nll = -ifm_log_likelihood(marginals, densities, theta)
    return torch.where(torch.isfinite(nll), nll, torch.full_like(nll, PENALTY))
