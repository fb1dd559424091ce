"""GARCH(p, q) volatility model on float64 tensors (counterpart of
`copula_var_tpu/models/garch.py`: the variance recursion, the Gaussian
log-likelihood, standardized residuals, the one-step forecast and the
simulators).

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
from typing import NamedTuple

import numpy as np
import torch

from copula_var_tpu_torch.device import generator

EPS_VAR_FLOOR = 1e-7  # reference `estimation.py:17` variance floor


class GarchParams(NamedTuple):
    """omega > 0, alpha (p,) > 0, beta (q,) > 0, sum(alpha)+sum(beta) < 1."""

    omega: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor


def validate_params(omega, alpha, beta) -> None:
    """Host-side parameter checks (reference `estimation.py:22-38`)."""
    alpha = np.asarray(alpha)
    beta = np.asarray(beta)
    if not np.all(alpha > 0):
        raise ValueError("All elements of alpha must be positive.")
    if not np.all(beta > 0):
        raise ValueError("All elements of beta must be positive.")
    if not omega > 0:
        raise ValueError("omega must be positive.")
    if alpha.sum() + beta.sum() >= 1:
        raise ValueError("sum(alpha) + sum(beta) must be < 1.")


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


def simulate(seed, omega, alpha, beta, n: int, device="cuda"):
    """Simulate a GARCH(p, q) series (`garch/generate_data.py:34-69`): a
    burn-in of max(p, q) steps is generated and discarded. `seed` is an
    int or a `torch.Generator` (whose device is used); parameters may
    carry a batch shape. Returns (y, sigma2, eps), each (..., n). The
    stream is torch's, not JAX's."""
    gen = generator(seed, device)
    ref = torch.zeros((), dtype=torch.float64, device=gen.device)
    omega = _as(omega, ref)
    alpha, beta = torch.atleast_1d(_as(alpha, ref)), torch.atleast_1d(
        _as(beta, ref))
    batch = torch.broadcast_shapes(omega.shape, alpha.shape[:-1],
                                   beta.shape[:-1])
    extra = max(alpha.shape[-1], beta.shape[-1])
    draws = torch.randn(batch + (n + extra - 1,), generator=gen,
                        dtype=ref.dtype, device=ref.device)
    return simulate_from_draws(draws, omega, alpha, beta, n)


def simulate_from_draws(draws, omega, alpha, beta, n: int):
    """The GARCH simulator driven by explicit N(0, 1) draws (..., n +
    max(p, q) - 1): one innovation per generated step t = 1 .. n + extra
    - 1 of the reference loop (`generate_data.py:55-69`, which leaves
    y[0] = 0 and sigma2[0] at the unconditional variance). Returns (y,
    sigma2, eps), each (..., n)."""
    draws = torch.as_tensor(draws, dtype=torch.float64)
    omega = _as(omega, draws)
    alpha, beta = torch.atleast_1d(_as(alpha, draws)), torch.atleast_1d(
        _as(beta, draws))
    p, q = alpha.shape[-1], beta.shape[-1]
    extra = max(p, q)
    batch = torch.broadcast_shapes(omega.shape, alpha.shape[:-1],
                                   beta.shape[:-1], draws.shape[:-1])
    s2_0 = (omega / (1.0 - alpha.sum(-1) - beta.sum(-1))).expand(batch)
    y2h = torch.zeros(batch + (p,), dtype=draws.dtype, device=draws.device)
    s2h = torch.nn.functional.pad(s2_0[..., None], (0, q - 1))
    ys, s2s = [torch.zeros_like(s2_0)], [s2_0]
    for z in torch.unbind(draws.expand(batch + draws.shape[-1:]), -1):
        s2 = omega + (y2h * alpha).sum(-1) + (s2h * beta).sum(-1)
        y = z * torch.sqrt(s2)
        y2h = torch.cat([(y * y)[..., None], y2h[..., :p - 1]], -1)
        s2h = torch.cat([s2[..., None], s2h[..., :q - 1]], -1)
        ys.append(y)
        s2s.append(s2)
    eps = torch.nn.functional.pad(draws.expand(batch + draws.shape[-1:]),
                                  (1, 0))
    return (torch.stack(ys, -1)[..., extra:],
            torch.stack(s2s, -1)[..., extra:], eps[..., extra:])
