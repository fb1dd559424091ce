"""Normal and Student-t distribution functions on float64 tensors
(counterpart of `copula_var_tpu/ops/special.py`).

`torch.special` has `ndtr`, `ndtri` and `gammaln` but no regularized
incomplete beta and no `betaln`, so `betainc` is written here: the same
modified-Lentz continued fraction, partial numerators, symmetry swap and
convergence rule as `jax.scipy.special.betainc` at f64, so the two agree
to the last few bits. `t_ppf` keeps the JAX version's safeguarded Newton
in log-survival space; its `while_loop` becomes a Python loop that exits
on a global `.any()` (one host sync per iteration, paid once in prep).

Every function takes tensors and keeps their dtype and device; scalar
parameters (`nu`, `mean`, `std`) may be Python floats.
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.9189385332046727417803297364056176  # log(sqrt(2*pi))


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def norm_pdf(x, mean=0.0, std=1.0):
    z = (x - mean) / std
    return torch.exp(-0.5 * z * z - _LOG_SQRT_2PI) / std


def norm_logpdf(x, mean=0.0, std=1.0):
    """Normal log pdf, elementwise, in JAX's order of terms."""
    z = (x - mean) / std
    return -0.5 * z * z - _LOG_SQRT_2PI - torch.log(_like(std, z))


_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def norm_cdf(x, mean=0.0, std=1.0):
    """Normal cdf by the erf/erfc split of `jax.scipy.special.ndtr`:
    1 + erf(w) near 0, erfc(|w|) in the tails (w = z / sqrt 2), keeping
    relative accuracy deep into the lower tail. (`torch.special.ndtr`
    underflows to 0 below z ~ -19.6 on the CPU, where the true value is
    still ~1e-86.)"""
    w = (x - mean) / std * _HALF_SQRT_2
    z = w.abs()
    y = torch.where(
        z < _HALF_SQRT_2,
        1.0 + torch.erf(w),
        torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)),
    )
    return 0.5 * y


def norm_ppf(p):
    return torch.special.ndtri(p)


def betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def betainc(a, b, x, max_iters: int = 600):
    """Regularized incomplete beta I_x(a, b), elementwise.

    Continued fraction (DLMF 8.17.22) by the modified Lentz method, on the
    side of the symmetry relation I_x(a,b) = 1 - I_{1-x}(b,a) where it
    converges fast (x < (a+1)/(a+b+2)). All lanes iterate together until
    every lane's last factor is within two ulps of one, capped at
    `max_iters`. `jax.scipy.special.betainc` waits for eps/2, which a
    factor oscillating between 1 - ulp/2 and 1 + ulp never meets: such a
    lane runs all 600 iterations and drifts by up to ~1e-13. Stopping at
    two ulps keeps the result within ~1e-15 of the converged fraction and
    ends the loop after tens of iterations."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    dtype = x.dtype
    eps2 = torch.finfo(dtype).eps / 2
    converged = 2.0 * torch.finfo(dtype).eps
    tiny2 = torch.finfo(dtype).tiny * 2

    a_zero = (a == 0) | (b == math.inf)
    b_zero = (b == 0) | (a == math.inf)
    x_zero, x_one = x == 0, x == 1
    result_zero = (b_zero & ~x_one) | (a_zero & x_zero)
    result_one = (a_zero & ~x_zero) | (b_zero & x_one)
    result_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero)
    result_nan = result_nan | torch.isnan(a) | torch.isnan(b) | torch.isnan(x)

    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)

    # Lentz: h_0 = b_0 = 0 -> small; partial denominators 1 thereafter
    small = torch.full_like(x, eps2)
    c = small.clone()
    d = torch.zeros_like(x)
    h = small.clone()
    apb = a + b
    for it in range(1, max_iters):
        if it == 1:
            num = torch.ones_like(x)
        else:
            m = float((it - 1) // 2)
            if it % 2 == 0:
                if m == 0:
                    num = -apb * x / (a + 1.0)
                else:
                    num = -(a + m) * (apb + m) * x / (
                        (a + 2.0 * m) * (a + 2.0 * m + 1.0)
                    )
            else:
                num = m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))
        c = 1.0 + num / c
        c = torch.where(c.abs() < eps2, small, c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < eps2, small, d)
        d = 1.0 / d
        delta = c * d
        h = h * delta
        if not bool(((delta - 1.0).abs() > converged).any()):
            break

    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(
        a < tiny2,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a,
    )
    out = h * factor
    out = torch.where(fast, out, 1.0 - out)
    out = torch.where(result_zero, torch.zeros_like(out), out)
    out = torch.where(result_one, torch.ones_like(out), out)
    return torch.where(result_nan, torch.full_like(out, math.nan), out)


# ---------------------------------------------------------------------------
# Student-t distribution
# ---------------------------------------------------------------------------


def t_logpdf(x, nu):
    nu = _like(nu, x)
    lognorm = (
        torch.lgamma((nu + 1.0) / 2.0)
        - torch.lgamma(nu / 2.0)
        - 0.5 * torch.log(nu * math.pi)
    )
    return lognorm - 0.5 * (nu + 1.0) * torch.log1p(x * x / nu)


def t_pdf(x, nu):
    """Student-t pdf, elementwise: exp(t_logpdf). Finite inputs only (the
    copula layer guards non-finite ones)."""
    return torch.exp(t_logpdf(x, nu))


_SMALL_Z = 1e-8  # below this betainc loses accuracy; the log series takes over


def _log_betainc_small(a, b, z):
    """log I_z(a, b) for small z from the hypergeometric series truncated
    at z^3 (relative error ~z^4); exact in log space arbitrarily deep into
    the tail."""
    zc = torch.clamp_max(z, _SMALL_Z)  # keep the unused branch finite
    c1 = (a + b) / (a + 1.0)
    c2 = c1 * (a + b + 1.0) / (a + 2.0)
    c3 = c2 * (a + b + 2.0) / (a + 3.0)
    series = 1.0 + zc * (c1 + zc * (c2 + zc * c3))
    return (
        a * torch.log(zc)
        + b * torch.log1p(-zc)
        - torch.log(a)
        - betaln(a, b)
        + torch.log(series)
    )


def t_sf(x, nu):
    """P(T > x) through I_{nu/(nu+x^2)}(nu/2, 1/2), with the small-z log
    series for deep tails."""
    nu = _like(nu, x)
    z = nu / (nu + x * x)
    half = torch.full_like(z, 0.5)
    a = (nu / 2.0).expand_as(z)
    body = betainc(a, half, z)
    deep = torch.exp(_log_betainc_small(a, half, z))
    tail = 0.5 * torch.where(z < _SMALL_Z, deep, body)
    return torch.where(x >= 0, tail, 1.0 - tail)


def t_cdf(x, nu):
    """Student-t cdf as t_sf(-x): the lower tail keeps its relative
    accuracy."""
    return t_sf(-x, nu)


def _log_t_sf(x_pos, nu):
    """log P(T > x) for x >= 0, accurate arbitrarily deep into the tail."""
    z = nu / (nu + x_pos * x_pos)
    half = torch.full_like(z, 0.5)
    a = (nu / 2.0).expand_as(z)
    ib = torch.clamp_min(betainc(a, half, z), torch.finfo(z.dtype).tiny)
    log_deep = _log_betainc_small(a, half, z)
    return math.log(0.5) + torch.where(z < _SMALL_Z, log_deep, torch.log(ib))


def _central_cut(dtype) -> float:
    """Cutoff on 0.5 - q below which t_ppf inverts the central Taylor
    series instead of running Newton (see the JAX version)."""
    return 3e-4 if dtype == torch.float64 else 4e-3


def t_ppf(p, nu, *, iters: int = 64):
    """Inverse Student-t cdf: bisection-safeguarded Newton on
    log Q(x) = log q in the upper tail, with the JAX version's
    convergence gate (step below 500 eps (|x| + 1), frozen lanes keep
    their x) and global early exit. Returns -inf/+inf at p = 0/1 and NaN
    outside [0, 1].

    The bracket stops growing once every lane's is wide enough (the JAX
    version runs all 8 doublings; a lane that is wide enough never changes
    again, so the result is the same)."""
    dtype = p.dtype
    nu = _like(nu, p)
    finfo = torch.finfo(dtype)

    q = torch.where(p > 0.5, 1.0 - p, p)
    sign = torch.where(p > 0.5, 1.0, -1.0).to(dtype)
    q_safe = torch.clamp(q, finfo.tiny, 0.5)
    log_q = torch.log(q_safe)

    # initial guesses: normal quantile (body), power law (tail)
    u = -torch.special.ndtri(q_safe)
    log_c = (0.5 * nu - 1.0) * torch.log(nu) - betaln(
        nu / 2.0, torch.full_like(nu, 0.5)
    )
    x_tail = torch.exp((log_c - log_q) / nu)
    x0 = torch.maximum(u, x_tail)
    x0 = torch.clamp(x0, 0.0, math.sqrt(finfo.max) * 0.1)

    # bracket [0, hi]: grow hi until Q(hi) <= q
    hi = x0 + 1.0
    for _ in range(8):
        ok = _log_t_sf(hi, nu) <= log_q
        if bool(ok.all()):
            break
        hi = torch.where(ok, hi, 2.0 * hi + 1.0)
    lo = torch.zeros_like(x0)

    eps_d = finfo.eps
    newton_lane = (0.5 - q_safe) >= _central_cut(dtype)

    def tol_x(v):
        return 500.0 * eps_d * (v.abs() + 1.0)

    x = x0
    step_mag = torch.full_like(x0, math.inf)
    for _ in range(iters):
        if not bool(((step_mag > tol_x(x)) & newton_lane).any()):
            break
        g = _log_t_sf(x, nu) - log_q
        log_sf = log_q + g
        dg = -torch.exp(t_logpdf(x, nu) - log_sf)
        step = g / dg
        lo = torch.where(g > 0, x, lo)
        hi = torch.where(g <= 0, x, hi)
        x_newton = x - step
        inside = (x_newton > lo) & (x_newton < hi)
        x_next = torch.where(inside, x_newton, 0.5 * (lo + hi))
        step_mag = step.abs()
        x = torch.where(step_mag <= tol_x(x), x, x_next)

    # central branch: odd Taylor series of the cdf around 0
    f0 = torch.exp(
        torch.lgamma((nu + 1.0) / 2.0) - torch.lgamma(nu / 2.0)
    ) / torch.sqrt(nu * math.pi)
    y = (0.5 - q_safe) / f0
    x_central = y + (nu + 1.0) / (6.0 * nu) * y**3
    x = torch.where(0.5 - q_safe < _central_cut(dtype), x_central, x)

    out = sign * x
    out = torch.where(p == 0.5, torch.zeros_like(out), out)
    out = torch.where(p <= 0.0, torch.full_like(out, -math.inf), out)
    out = torch.where(p >= 1.0, torch.full_like(out, math.inf), out)
    return torch.where((p < 0.0) | (p > 1.0), torch.full_like(out, math.nan), out)
