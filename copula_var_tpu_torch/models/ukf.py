"""Unscented-Kalman-filter mean-reverting log-vol model on float64 tensors
(counterpart of `copula_var_tpu/models/ukf.py`: the filter, its
log-likelihood, vol path, residuals and one-step forecast, and the OU
simulator).

Model: log-vol x_t = a (x_{t-1} - l) + l + q w_t, r_t = e^{x_t} v_t.
UKF constants: L = 2 (augmented state + noise), lambda = alpha^2 (L +
kappa) - L, alpha = 1.6, beta = 2, kappa = 1.75. The augmented covariance
is diag(var, 1), so the 5 prediction sigma points and the 2x2 Cholesky
take closed scalar forms (sqrt(var), regularized by +1e-8 only when var
<= 0). The measurement update weights the 3 sigma points of the predicted
state by h(x) = phi(r e^{-x}) |r e^{-x}|; their weighted sum Z is the
step's likelihood, and a step with Z < 1e-10 (or NaN) is skipped and
marks the series invalid (LL = FAIL_LL).

Every function broadcasts the parameters `a`, `l`, `q` (batch shape Bp)
against `returns` (batch shape Br, then N): a row of EM candidates or
assets on their series (the fit), or rolling windows under one parameter
set per asset (the forecasts). The filter is a Python loop over time
whose every step is a few batched ops on (rows,) tensors, so launches
scale with the N steps and not with the rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from copula_var_tpu_torch.device import generator

ALPHA = 1.6
BETA = 2.0
KAPPA = 1.75
_L = 2
_CHOL_EPS = 1e-8
_Z_FLOOR = 1e-10
FAIL_LL = -1e10  # reference sentinel (`estimate.py:219-220,270-271`)

_INV_SQRT_2PI = 0.3989422804014327

# sigma-point weights (`calc_weights`, `calc_weights_2`): wm2 is the first
# three of wm and does not sum to 1, a reference quirk kept for parity
_LAM = ALPHA**2 * (_L + KAPPA) - _L
_W_REST = 1.0 / (2.0 * (_L + _LAM))
_WM0 = _LAM / (_L + _LAM)
_WC0 = _WM0 + (1.0 - ALPHA**2 + BETA)
_PHI = math.sqrt(_L + _LAM)


class UkfParams(NamedTuple):
    """a: mean-reversion speed, l: long-run mean, q: process vol."""

    a: torch.Tensor
    l: torch.Tensor  # noqa: E741  (the model's own parameter name)
    q: torch.Tensor


def _as(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def filter_series(returns, a, l, q, init_log_vol=None,  # noqa: E741
                  init_var=None):
    """Run the UKF over `returns` (..., N).

    Defaults init_log_vol = l and init_var = q (not q^2), as every
    reference call site has them.

    Returns (state_mean (..., N), state_var (..., N), log_lik (...),
    forecast (...), valid (...) bool). `forecast` is the last step's
    predicted (prior) mean, not its posterior. An invalid series has LL
    == FAIL_LL.
    """
    returns = torch.as_tensor(returns, dtype=torch.float64)
    a, l, q = (_as(v, returns) for v in (a, l, q))
    rows = torch.broadcast_shapes(a.shape, l.shape, q.shape,
                                  returns.shape[:-1])
    # the row state is kept as (..., 1) so that every step broadcasts
    # against the sigma points without a reshape
    a, l, q = (v.expand(rows)[..., None] for v in (a, l, q))
    mean = l if init_log_vol is None else _as(
        init_log_vol, returns).expand(rows)[..., None]
    var = q if init_var is None else _as(
        init_var, returns).expand(rows)[..., None]
    dt, dev = returns.dtype, returns.device
    # prediction sigma points: [m, m + phi sv, m, m - phi sv, m] with
    # noise [0, 0, phi, 0, -phi]; update points: xm + phi sP [0, 1, -1]
    spread5 = torch.tensor([0.0, _PHI, 0.0, -_PHI, 0.0], dtype=dt, device=dev)
    noise5 = q * torch.tensor([0.0, 0.0, _PHI, 0.0, -_PHI], dtype=dt,
                              device=dev)
    spread3 = torch.tensor([0.0, _PHI, -_PHI], dtype=dt, device=dev)
    wm = torch.tensor([[_WM0]] + [[_W_REST]] * 4, dtype=dt, device=dev)
    wc = torch.tensor([[_WC0]] + [[_W_REST]] * 4, dtype=dt, device=dev)
    wm2 = wm[:3]
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    ll = torch.zeros(rows + (1,), dtype=dt, device=dev)
    ok = torch.ones(rows + (1,), dtype=torch.bool, device=dev)
    r_steps = torch.unbind(
        returns.expand(rows + returns.shape[-1:])[..., None], -2)
    means, variances = [], []
    x_mean = mean
    for r in r_steps:
        sv = torch.sqrt(torch.where(var > 0.0, var, var + _CHOL_EPS))
        X = a * (mean + sv * spread5 - l) + l + noise5
        x_mean = X @ wm
        d = X - x_mean
        P = (d * d) @ wc
        X2 = x_mean + torch.sqrt(P) * spread3
        eta = r / torch.exp(X2)
        h = _INV_SQRT_2PI * torch.exp(-0.5 * eta * eta) * torch.abs(eta)
        Z = h @ wm2
        step_ok = Z >= _Z_FLOOR  # NaN fails too
        Zs = torch.where(step_ok, Z, one)
        post_mean = ((X2 * h) @ wm2) / Zs
        dev2 = X2 - post_mean
        post_var = ((h / Zs) * dev2 * dev2) @ wm2
        ok = ok & step_ok
        mean = torch.where(step_ok, post_mean, mean)
        var = torch.where(step_ok, post_var, var)
        ll = ll + torch.where(step_ok, torch.log(torch.abs(Zs)), zero)
        means.append(mean)
        variances.append(var)
    ll = torch.where(ok, ll, FAIL_LL)[..., 0]
    return (torch.cat(means, -1), torch.cat(variances, -1), ll,
            x_mean[..., 0], ok[..., 0])


def log_likelihood(returns, a, l, q):  # noqa: E741
    """Filter log-likelihood sum log|Z_t| (`estimate.py:276`) -> (...)."""
    return filter_series(returns, a, l, q)[2]


def vol_path(returns, a, l, q):  # noqa: E741
    """exp(filtered state) (`estimate.py:46-48`) -> (..., N)."""
    return torch.exp(filter_series(returns, a, l, q)[0])


def standardized_residuals(returns, a, l, q):  # noqa: E741
    """eps_t = r_t / exp(x_t) (`estimate.py:50-51`) -> (..., N)."""
    returns = torch.as_tensor(returns, dtype=torch.float64)
    return returns / vol_path(returns, a, l, q)


def forecast_vol(returns, a, l, q):  # noqa: E741
    """One-step vol forecast exp(last prior mean) (`forecast.py:5-12`)
    -> (...)."""
    return torch.exp(filter_series(returns, a, l, q)[3])


def log_likelihood_batch(returns, a, l, q):  # noqa: E741
    """Log-likelihood of one series (N,) under candidate rows a, l, q
    (C,) -> (C,)."""
    return log_likelihood(returns, a, l, q)


def forecast_vol_windows(windows, a, l, q):  # noqa: E741
    """Forecast over rolling windows (T, N) under one parameter set ->
    (T,); with parameters (A, 1) and windows (A, T, N), every asset's
    windows at once -> (A, T)."""
    return forecast_vol(windows, a, l, q)


def simulate(seed, a, l, q, n: int, device="cuda"):  # noqa: E741
    """OU log-vol simulator (`generate.py:18-32`): X_0 = l,
    X_t = a (X_{t-1} - l) + l + q N(0, 1); vol = e^X; r = vol N(0, 1).
    `seed` is an int or a `torch.Generator` (whose device is used);
    parameters may carry a batch shape. Returns (X, vol, returns), each
    (..., n). The stream is torch's, not JAX's."""
    gen = generator(seed, device)
    ref = torch.zeros((), dtype=torch.float64, device=gen.device)
    a, l, q = (_as(v, ref) for v in (a, l, q))
    batch = torch.broadcast_shapes(a.shape, l.shape, q.shape)
    dw = torch.randn(batch + (n - 1,), generator=gen, dtype=ref.dtype,
                     device=ref.device)
    x = l.expand(batch)
    xs = [x]
    for w in torch.unbind(dw, -1):
        x = a * (x - l) + l + q * w
        xs.append(x)
    X = torch.stack(xs, -1)
    vol = torch.exp(X)
    r = vol * torch.randn(batch + (n,), generator=gen, dtype=ref.dtype,
                          device=ref.device)
    return X, vol, r
