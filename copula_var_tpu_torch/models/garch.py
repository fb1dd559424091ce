"""GARCH(p, q) volatility model on float64 tensors (counterpart of
`copula_var_tpu/models/garch.py`: the variance recursion, the Gaussian
log-likelihood, standardized residuals and the one-step forecast; the
simulators are not ported yet).

Every function broadcasts over leading batch axes: `returns` (..., N)
against `omega` (...), `alpha` (..., p) and `beta` (..., q). That one
form serves a row of candidates on one series (the fit), rows of
rolling windows under one parameter set (the forecasts), and both at
once. The JAX module vmaps a one-series scan instead.

The recursion is a Python loop over time whose every step is a few
batched tensor ops, so launches scale with the N steps and not with the
rows. The ARCH term does not depend on the recursion and is formed for
all steps at once before the loop.
"""

from __future__ import annotations

import math

import torch

EPS_VAR_FLOOR = 1e-7  # reference `estimation.py:17` variance floor


def _as(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def conditional_variances(returns, omega, alpha, beta):
    """sigma^2_t path (..., N); matches `estimation.py:40-65`.

    sigma2[0] = omega / (1 - sum(alpha) - sum(beta)) (no floor at t=0);
    sigma2[t>=1] = max(omega + sum_i alpha_i r^2_{t-1-i}
                       + sum_j beta_j sigma^2_{t-1-j}, 1e-7)
    with zero pre-sample history (the history starts as [sigma2[0], 0, ..]).
    """
    omega = _as(omega, returns)
    alpha = _as(alpha, returns)
    beta = _as(beta, returns)
    p, q = alpha.shape[-1], beta.shape[-1]
    n = returns.shape[-1]
    s2_0 = omega / (1.0 - alpha.sum(-1) - beta.sum(-1))
    r2 = returns * returns
    # ARCH term of steps t = 1..N-1: sum_i alpha_i r^2_{t-1-i}
    arch = None
    for i in range(p):
        lagged = torch.nn.functional.pad(r2[..., : n - 1 - i], (i, 0))
        term = alpha[..., i, None] * lagged
        arch = term if arch is None else arch + term
    pre = omega[..., None] + arch  # (..., N-1)
    s2_0 = s2_0.expand(pre.shape[:-1])
    hist = torch.nn.functional.pad(s2_0[..., None], (0, q - 1))
    out = [s2_0]
    # unbind, not pre[..., t]: an indexed step's backward would build a
    # zero gradient of all of pre, O(N^2) over the recursion
    for pre_t in torch.unbind(pre, -1):
        s2 = torch.clamp_min(pre_t + (hist * beta).sum(-1), EPS_VAR_FLOOR)
        out.append(s2)
        hist = torch.cat([s2[..., None], hist[..., : q - 1]], -1)
    return torch.stack(out, -1)


def log_likelihood(returns, omega, alpha, beta):
    """Gaussian log-likelihood with the first max(p, q) observations
    chopped (`estimation.py:91-125`) -> (...)."""
    extra = max(_as(alpha, returns).shape[-1], _as(beta, returns).shape[-1])
    s2 = conditional_variances(returns, omega, alpha, beta)[..., extra:]
    r = returns[..., extra:]
    return -0.5 * torch.sum(torch.log(2.0 * math.pi * s2) + (r * r) / s2,
                            -1)


def standardized_residuals(returns, omega, alpha, beta):
    """eps_t = r_t / sigma_t (`estimation.py:76-89`)."""
    s2 = conditional_variances(returns, omega, alpha, beta)
    return returns / torch.sqrt(s2)


def forecast_vol(returns, omega, alpha, beta):
    """One-step-ahead sigma forecast (`garch/forecast.py:5-18`) -> (...).

    Reproduced quirk: alpha[i] multiplies returns[-p + i], the oldest of
    the last p returns first, the reverse of the recursion's order.
    Identical at p = q = 1; kept for output parity at p, q > 1.
    """
    alpha = _as(alpha, returns)
    beta = _as(beta, returns)
    p, q = alpha.shape[-1], beta.shape[-1]
    s2 = conditional_variances(returns, omega, alpha, beta)
    f = (_as(omega, returns) + torch.sum(alpha * returns[..., -p:] ** 2, -1)
         + torch.sum(beta * s2[..., -q:], -1))
    return torch.sqrt(f)


def forecast_vol_padded(returns, omega, alpha, beta, p, q):
    """`forecast_vol` for end-zero-padded coefficient rows (..., p_max),
    (..., q_max) with true lag counts p, q (...): the last p returns are
    gathered at their true offsets, so the pairing quirk survives the
    padding."""
    alpha = _as(alpha, returns)
    beta = _as(beta, returns)
    pm, qm = alpha.shape[-1], beta.shape[-1]
    n = returns.shape[-1]
    s2 = conditional_variances(returns, omega, alpha, beta)
    p = torch.as_tensor(p, device=returns.device)[..., None]
    q = torch.as_tensor(q, device=returns.device)[..., None]
    i = torch.arange(pm, device=returns.device)
    j = torch.arange(qm, device=returns.device)

    def tail(v, k, idx):
        at = torch.clamp(n - k + idx, 0, n - 1)
        got = torch.take_along_dim(
            v, at.expand(v.shape[:-1] + at.shape[-1:]), -1)
        return torch.where(idx < k, got, torch.zeros_like(got))

    r_tail = tail(returns, p, i)
    s_tail = tail(s2, q, j)
    f = (_as(omega, returns) + torch.sum(alpha * r_tail * r_tail, -1)
         + torch.sum(beta * s_tail, -1))
    return torch.sqrt(f)


def log_likelihood_batch(returns, omega, alpha, beta):
    """Log-likelihood of one series (N,) under a leading batch of
    candidates omega (C,), alpha (C, p), beta (C, q) -> (C,)."""
    return log_likelihood(returns, omega, alpha, beta)


def forecast_vol_windows(windows, omega, alpha, beta):
    """Forecast over rolling windows (T, N) under one parameter set ->
    (T,)."""
    return forecast_vol(windows, omega, alpha, beta)
